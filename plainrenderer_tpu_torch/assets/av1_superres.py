"""AV1 superres upscaling (the AV1 specification, section 7.16) as dav1d
1.5.1 does it (mc_tmpl.c's resize_c, decode.c's resize_step and
resize_start): between CDEF and loop restoration, each plane's rows are
widened from the coded width to the upscaled width by the 64-phase 8-tap
Upscale_Filter. A plane's step is its coded width over its upscaled
width in 1/16384 of a sample, rounded; its first position carries
half the rounding error (C's truncating divisions); the taps read
columns clamped to the plane's part of the mode info grid (MiCols * 4
luma samples, past the coded width), and the sums round by 7 bits and
clip to the bit depth. Each row is filtered whole: dav1d does not split
it at tile columns, and libaom's per-column offsets add up to the same
positions. The planes keep their dtype (uint8 at 8 bits, uint16 above).
"""

from __future__ import annotations

import numpy as np

# Upscale_Filter[64][8] (libaom's av1_resize_filter_normative; dav1d's
# dav1d_resize_filter holds its negation)
FILTERS = np.array((
    (0, 0, 0, 128, 0, 0, 0, 0), (0, 0, -1, 128, 2, -1, 0, 0),
    (0, 1, -3, 127, 4, -2, 1, 0), (0, 1, -4, 127, 6, -3, 1, 0),
    (0, 2, -6, 126, 8, -3, 1, 0), (0, 2, -7, 125, 11, -4, 1, 0),
    (-1, 2, -8, 125, 13, -5, 2, 0), (-1, 3, -9, 124, 15, -6, 2, 0),
    (-1, 3, -10, 123, 18, -6, 2, -1), (-1, 3, -11, 122, 20, -7, 3, -1),
    (-1, 4, -12, 121, 22, -8, 3, -1), (-1, 4, -13, 120, 25, -9, 3, -1),
    (-1, 4, -14, 118, 28, -9, 3, -1), (-1, 4, -15, 117, 30, -10, 4, -1),
    (-1, 5, -16, 116, 32, -11, 4, -1), (-1, 5, -16, 114, 35, -12, 4, -1),
    (-1, 5, -17, 112, 38, -12, 4, -1), (-1, 5, -18, 111, 40, -13, 5, -1),
    (-1, 5, -18, 109, 43, -14, 5, -1), (-1, 6, -19, 107, 45, -14, 5, -1),
    (-1, 6, -19, 105, 48, -15, 5, -1), (-1, 6, -19, 103, 51, -16, 5, -1),
    (-1, 6, -20, 101, 53, -16, 6, -1), (-1, 6, -20, 99, 56, -17, 6, -1),
    (-1, 6, -20, 97, 58, -17, 6, -1), (-1, 6, -20, 95, 61, -18, 6, -1),
    (-2, 7, -20, 93, 64, -18, 6, -2), (-2, 7, -20, 91, 66, -19, 6, -1),
    (-2, 7, -20, 88, 69, -19, 6, -1), (-2, 7, -20, 86, 71, -19, 6, -1),
    (-2, 7, -20, 84, 74, -20, 7, -2), (-2, 7, -20, 81, 76, -20, 7, -1),
    (-2, 7, -20, 79, 79, -20, 7, -2), (-1, 7, -20, 76, 81, -20, 7, -2),
    (-2, 7, -20, 74, 84, -20, 7, -2), (-1, 6, -19, 71, 86, -20, 7, -2),
    (-1, 6, -19, 69, 88, -20, 7, -2), (-1, 6, -19, 66, 91, -20, 7, -2),
    (-2, 6, -18, 64, 93, -20, 7, -2), (-1, 6, -18, 61, 95, -20, 6, -1),
    (-1, 6, -17, 58, 97, -20, 6, -1), (-1, 6, -17, 56, 99, -20, 6, -1),
    (-1, 6, -16, 53, 101, -20, 6, -1), (-1, 5, -16, 51, 103, -19, 6, -1),
    (-1, 5, -15, 48, 105, -19, 6, -1), (-1, 5, -14, 45, 107, -19, 6, -1),
    (-1, 5, -14, 43, 109, -18, 5, -1), (-1, 5, -13, 40, 111, -18, 5, -1),
    (-1, 4, -12, 38, 112, -17, 5, -1), (-1, 4, -12, 35, 114, -16, 5, -1),
    (-1, 4, -11, 32, 116, -16, 5, -1), (-1, 4, -10, 30, 117, -15, 4, -1),
    (-1, 3, -9, 28, 118, -14, 4, -1), (-1, 3, -9, 25, 120, -13, 4, -1),
    (-1, 3, -8, 22, 121, -12, 4, -1), (-1, 3, -7, 20, 122, -11, 3, -1),
    (-1, 2, -6, 18, 123, -10, 3, -1), (0, 2, -6, 15, 124, -9, 3, -1),
    (0, 2, -5, 13, 125, -8, 2, -1), (0, 1, -4, 11, 125, -7, 2, 0),
    (0, 1, -3, 8, 126, -6, 2, 0), (0, 1, -3, 6, 127, -4, 1, 0),
    (0, 1, -2, 4, 127, -3, 1, 0), (0, 0, -1, 2, 128, -1, 0, 0)), np.int32)
_ROWS = 1 << 16     # output samples filtered at once, per tap


def _div(a: int, b: int) -> int:
    """C's integer division (truncating towards zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def step_and_start(coded: int, upscaled: int) -> tuple[int, int]:
    """(step, initial position) in 1/16384 of a sample for a plane coded
    `coded` samples wide and shown `upscaled` wide: dav1d's scale_fac and
    get_upscale_x0."""
    step = ((coded << 14) + (upscaled >> 1)) // upscaled
    err = upscaled * step - (coded << 14)
    x0 = (_div(-((upscaled - coded) << 13) + (upscaled >> 1), upscaled)
          + 128 - _div(err, 2))
    return step, x0 & 0x3FFF


def upscale(plane: np.ndarray, rows: int, src_w: int, coded: int,
            upscaled: int, bit_depth: int) -> np.ndarray:
    """The first `rows` rows of `plane` widened to `upscaled` columns, the
    taps reading columns 0 .. src_w - 1 of it (src_w the plane's mode
    info width in samples); `coded` is the plane's coded width."""
    step, x0 = step_and_start(coded, upscaled)
    pos = x0 + np.arange(upscaled, dtype=np.int64) * step
    first = (pos >> 14) - 1 - 3      # the leftmost tap of each output
    taps = np.clip(first[:, None] + np.arange(8), 0, src_w - 1)
    filt = FILTERS[(pos & 0x3FFF) >> 8]
    out = np.empty((rows, upscaled), plane.dtype)
    chunk = max(1, _ROWS // upscaled)
    top = (1 << bit_depth) - 1
    for r0 in range(0, rows, chunk):
        src = plane[r0:min(rows, r0 + chunk)]
        acc = np.zeros((src.shape[0], upscaled), np.int32)
        for k in range(8):
            acc += filt[:, k] * src[:, taps[:, k]].astype(np.int32)
        out[r0:r0 + src.shape[0]] = np.clip((acc + 64) >> 7, 0, top)
    return out


def apply(seq, hdr, planes: list) -> list:
    """The frame state's planes (CDEF's output, or the deblocked copy loop
    restoration reads) upscaled: each plane's rows of the frame, at the
    upscaled width."""
    out = []
    for p, plane in enumerate(planes):
        sx = seq.ssx if p else 0
        sy = seq.ssy if p else 0
        out.append(upscale(plane, (hdr.height + sy) >> sy,
                           (hdr.mi_cols * 4) >> sx, (hdr.width + sx) >> sx,
                           (hdr.upscaled_width + sx) >> sx, seq.bit_depth))
    return out
