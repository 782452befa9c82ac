"""JPEG 2000 reconstruction (T.800 Annexes E, F, G), as OpenJPEG 2.5.4's
t1.c, dwt.c, mct.c and tcd.c compute it, in the same float32 operations
for the irreversible path.

``decode_tile`` runs a tile: tier 2 (j2k_t2), tier 1 for every code-block
(j2k_t1), then

  - ROI: with an RGN maxshift s, coefficients whose magnitude (with the
    decoder's extra half bit) reaches 2^s are shifted down by s;
  - dequantisation: 5/3 halves the coefficient (C division, toward zero);
    9/7 multiplies it, as float32, by float32(0.5 * step size), where the
    step size has no sub-band gain (t1.c, tcd.c);
  - the inverse DWT over resno_decoded + 1 resolutions, each level rows
    first, then columns, the first sample's parity from the resolution's
    corner: 5/3 in int32 lifting with symmetric extension (a lone odd
    sample halved); 9/7 in float32, lows scaled by K = 1.230174105 and
    highs by OpenJPEG's 2 / K = 1.625732422, then the four lifting steps
    x += (left + right) * c with c = -delta, -gamma, -beta, -alpha (a lone
    sample of either parity left as it is);
  - RCT (integers) or ICT (float32, r = y + v * 1.402, g = y - u * 0.34413
    - v * 0.71414, b = y + u * 1.772) on the first three components, by
    the first component's transform, when COD's MCT is set;
  - the DC level shift, with the float path rounded half to even (lrintf)
    before it, then the clamp to the component's range.

Every component comes back as int32 at the size of its resolution
resno_decoded (the whole tile-component unless a progression never
reached its highest resolution)."""

from __future__ import annotations

import numpy as np

from . import j2k_ht, j2k_t1, j2k_t2
from .j2k_codestream import HT, J2kError

K = np.float32(1.230174105)
TWO_INVK = np.float32(1.625732422)
LIFT = (np.float32(-0.443506852), np.float32(-0.882911075),
        np.float32(0.052980118), np.float32(1.586134342))
_MIRROR: dict = {}


def line_layout(n: int, cas: int):
    """Positions of the lows and highs of an n-sample line, and each
    position's mirrored left and right neighbours."""
    key = (n, cas)
    if key not in _MIRROR:
        pos = np.arange(n)
        low = pos[(pos + cas) % 2 == 0]
        high = pos[(pos + cas) % 2 == 1]

        def mirror(i):
            i = np.abs(i)
            return np.where(i > n - 1, 2 * (n - 1) - i, i)

        _MIRROR[key] = (low, high, mirror(low - 1), mirror(low + 1),
                        mirror(high - 1), mirror(high + 1))
    return _MIRROR[key]


def _idwt53(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Inverse 5/3 along the last axis of int32 ``x`` (lows first)."""
    n = x.shape[-1]
    if n == 1:
        if cas:
            v = x.astype(np.int64)
            return (np.sign(v) * (np.abs(v) // 2)).astype(np.int32)
        return x
    low, high, ll, lr, hl, hr = line_layout(n, cas)
    out = np.empty_like(x)
    out[..., low] = x[..., :sn]
    out[..., high] = x[..., sn:]
    out[..., low] -= (out[..., ll] + out[..., lr] + np.int32(2)) >> 2
    out[..., high] += (out[..., hl] + out[..., hr]) >> 1
    return out


def _idwt97(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Inverse 9/7 along the last axis of float32 ``x`` (lows first)."""
    n = x.shape[-1]
    if n == 1:
        return x
    low, high, ll, lr, hl, hr = line_layout(n, cas)
    out = np.empty_like(x)
    out[..., low] = x[..., :sn] * K
    out[..., high] = x[..., sn:] * TWO_INVK
    for step, c in enumerate(LIFT):
        if step % 2 == 0:
            out[..., low] = out[..., low] + (out[..., ll] + out[..., lr]) * c
        else:
            out[..., high] = out[..., high] + (out[..., hl] + out[..., hr]) * c
    return out


def _inverse_dwt(data: np.ndarray, tc, numres: int, irreversible: bool):
    if numres == 1 or data.shape[1] == 0:
        return
    inv = _idwt97 if irreversible else _idwt53
    r = tc.res[0]
    rw, rh = r.x1 - r.x0, r.y1 - r.y0
    for resno in range(1, numres):
        r = tc.res[resno]
        sw, sh = rw, rh
        rw, rh = r.x1 - r.x0, r.y1 - r.y0
        if rh and rw:
            data[:rh, :rw] = inv(data[:rh, :rw], sw, r.x0 % 2)
            data[:rh, :rw] = inv(data[:rh, :rw].T, sh, r.y0 % 2).T


def band_origin(tc, resno: int, b) -> tuple[int, int]:
    """Where sub-band ``b`` of resolution ``resno`` starts in the
    tile-component's plane, whose resolutions hold their lows first and
    their highs after them along each axis."""
    p = tc.res[resno - 1] if resno else None
    return (p.x1 - p.x0 if b.bandno & 1 else 0,
            p.y1 - p.y0 if b.bandno & 2 else 0)


def _cblk_segments(cb):
    data = b"".join(cb.chunks)
    out = []
    pos = 0
    for seg in cb.segs:
        out.append((data[pos:pos + seg[2]], seg[1]))
        pos += seg[2]
    return out


def _ht_cblk(cb, w, h, b, tccp):
    """An HT code-block (assets/j2k_ht.py): OpenJPEG reads a block of one
    chunk where tier 2 left it in the tile's data, and copies several
    into its own (aligned) buffer."""
    align = cb.chunk_at[0] % 4 if len(cb.chunks) == 1 else 0
    return j2k_ht.decode_cblk(b"".join(cb.chunks),
                              [(s[2], s[1]) for s in cb.segs], w, h,
                              cb.numbps, b.numbps, tccp.roishift,
                              tccp.cblksty, align)


def decode_tile(cs, tileno: int, tcp, data: bytes, ppm_state):
    """(tile rectangle, [int32 (h, w) per component]) of one tile."""
    tile, comps = j2k_t2.tile_geometry(cs, tileno, tcp)
    j2k_t2.read_packets(tcp, comps, tile, data, ppm_state)
    planes = []
    for compno, tc in enumerate(comps):
        tccp = tcp.tccps[compno]
        top = tc.res[-1]
        w, h = top.x1 - top.x0, top.y1 - top.y0
        irrev = tccp.qmfbid == 0
        plane = np.zeros((h, w), np.float32 if irrev else np.int32)
        for resno, r in enumerate(tc.res):
            for b in r.bands:
                xoff, yoff = band_origin(tc, resno, b)
                for pr in b.precincts:
                    for cb in pr.cblks:
                        cw, chh = cb.x1 - cb.x0, cb.y1 - cb.y0
                        if cw <= 0 or chh <= 0:
                            continue
                        if cb.chunks and tccp.cblksty & HT:
                            v = _ht_cblk(cb, cw, chh, b, tccp)
                        elif cb.chunks:
                            v = j2k_t1.decode_cblk(
                                _cblk_segments(cb), cw, chh, b.bandno,
                                cb.numbps, tccp.roishift, tccp.cblksty)
                        else:
                            v = np.zeros((chh, cw), np.int64)
                        if tccp.roishift:
                            if tccp.roishift >= 31:
                                v = np.zeros_like(v)
                            else:
                                mag = np.abs(v)
                                big = mag >= (1 << tccp.roishift)
                                mag = np.where(big, mag >> tccp.roishift, mag)
                                v = np.where(v < 0, -mag, mag)
                        x0, y0 = cb.x0 - b.x0 + xoff, cb.y0 - b.y0 + yoff
                        if irrev:
                            step = np.float32(np.float32(0.5) * b.stepsize)
                            plane[y0:y0 + chh, x0:x0 + cw] = \
                                v.astype(np.int32).astype(np.float32) * step
                        else:
                            q = np.sign(v) * (np.abs(v) // 2)
                            plane[y0:y0 + chh, x0:x0 + cw] = q.astype(np.int32)
        _inverse_dwt(plane, tc, tc.resno_decoded + 1, irrev)
        planes.append(plane)
    _mct(tcp, comps, planes)
    out = []
    for compno, tc in enumerate(comps):
        prec, sgnd = cs.comps[compno][0], cs.comps[compno][1]
        r = tc.res[tc.resno_decoded]
        p = planes[compno][:r.y1 - r.y0, :r.x1 - r.x0]
        if sgnd:
            lo, hi, shift = -(1 << (prec - 1)), (1 << (prec - 1)) - 1, 0
        else:
            lo, hi, shift = 0, (1 << prec) - 1, 1 << (prec - 1)
        if tcp.tccps[compno].qmfbid == 1:
            v = p.view(np.int32).astype(np.int64) + shift
        else:  # lrintf (half to even), then the shift; NaN gives LONG_MIN
            f = p.view(np.float32).astype(np.float64)
            v = np.where(np.isnan(f), -2.0 ** 63, np.rint(f)) + shift
            v = np.where(f > 2.0 ** 31, hi, np.where(f < -2.0 ** 31, lo, v))
        out.append(np.clip(v, lo, hi).astype(np.int32))
    return tile, out


def _mct(tcp, comps, planes):
    if tcp.mct == 0:
        return
    if len(planes) < 3:
        return
    shapes = {p.shape for p in planes[:3]}
    levels = {(tc.numres, tc.resno_decoded) for tc in comps[:3]}
    if len(shapes) != 1 or len(levels) != 1:
        raise J2kError("Tiles don't all have the same dimension. Skip the "
                       "MCT step.")
    if tcp.tccps[0].qmfbid == 1:
        y, u, v = (p.view(np.int32) for p in planes[:3])
        g = y - ((u + v) >> 2)
        r = v + g
        b = u + g
        planes[0][...] = r.view(planes[0].dtype)
        planes[1][...] = g.view(planes[1].dtype)
        planes[2][...] = b.view(planes[2].dtype)
    else:
        y, u, v = (p.view(np.float32) for p in planes[:3])
        r = y + v * np.float32(1.402)
        g = y - u * np.float32(0.34413) - v * np.float32(0.71414)
        b = y + u * np.float32(1.772)
        planes[0][...] = r.view(planes[0].dtype)
        planes[1][...] = g.view(planes[1].dtype)
        planes[2][...] = b.view(planes[2].dtype)
