"""The forward reversible 5/3 wavelet transform, as OpenJPEG 2.5.4's dwt.c
computes it for the encoder (opj_dwt_encode).

Each level, from the tile-component's highest resolution down, filters
the resolution's rectangle of the int32 plane vertically (every column),
then horizontally (every row), and leaves the lows first and the highs
after them along each axis, so that the next level works on the low-low
corner. A line's first sample is a low where the resolution's origin is
even (``cas`` 0) and a high where it is odd. The lifting is integer, with
whole-sample symmetric extension at both ends:

    high[i] = x[2i + 1 - cas] - ((left + right) >> 1)
    low[i]  = x[2i + cas] + ((high left + high right + 2) >> 2)

and a line of one sample is left as it is (cas 0) or doubled (cas 1).
``j2k_recon._inverse_dwt`` undoes it exactly."""

from __future__ import annotations

import numpy as np

from .j2k_recon import line_layout


def fdwt53(x: np.ndarray, cas: int) -> np.ndarray:
    """Forward 5/3 along the last axis of int32 ``x``: the lows, then the
    highs."""
    n = x.shape[-1]
    if n == 1:
        return x * np.int32(2) if cas else x.copy()
    low, high, ll, lr, hl, hr = line_layout(n, cas)
    out = x.copy()
    out[..., high] -= (out[..., hl] + out[..., hr]) >> 1
    out[..., low] += (out[..., ll] + out[..., lr] + np.int32(2)) >> 2
    return np.concatenate([out[..., low], out[..., high]], axis=-1)


def forward_dwt(plane: np.ndarray, tc) -> None:
    """Transform the int32 ``plane`` of tile-component ``tc``
    (j2k_t2.tile_geometry's) in place over its tc.numres resolutions."""
    for resno in range(tc.numres - 1, 0, -1):
        r = tc.res[resno]
        rw, rh = r.x1 - r.x0, r.y1 - r.y0
        if rw and rh:
            plane[:rh, :rw] = fdwt53(plane[:rh, :rw].T, r.y0 % 2).T
            plane[:rh, :rw] = fdwt53(plane[:rh, :rw], r.x0 % 2)
