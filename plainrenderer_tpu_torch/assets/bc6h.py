"""BC6H block decoding without PIL, as Pillow 12.1's libImaging/BcnDecode.c
decodes it (DDS DXGI formats 95, UF16, and 96, SF16), vectorised over the
blocks of each mode.

A block's mode is its low 2 bits where they are 00 or 01, else its low 5
bits; the 14 modes fix the subsets (2, with the first 32 of BC7's
two-subset partitions, or 1), the base endpoint precision, the precision
of the other endpoints and whether they are deltas from the base
("transformed"), and where each endpoint bit lies (_LAYOUTS: the BC6H
specification's table). Deltas are sign-extended and added to the base
modulo its precision (in SF16 the base and, where not transformed, every
endpoint is sign-extended first; a sum stays unsigned, and a 16-bit
endpoint keeps its unsigned 16-bit value, as in PIL). Each
endpoint is unquantised to 16 bits, pixels interpolate as (e0 (64 - w) +
e1 w) >> 6 (no rounding term, as in PIL) with the BC7 weights of 3-bit
(two subsets) or 4-bit (one subset) indices, anchors storing one bit
fewer, and the result is scaled by 31/64 (UF16) or 31/32
(SF16, on the magnitude) to an f16 bit pattern. PIL's image is 8-bit RGB:
each f16 value becomes 0 below 0, 255 above 1, else trunc(v * 255) in
single precision. The reserved modes (low 5 bits 10011, 10111, 11011,
11111) decode as PIL decodes them: black.
"""

from __future__ import annotations

import re

import numpy as np

from .bc7 import WEIGHTS, Bits, subsets_and_anchors

# after the mode bits, each endpoint component's bits in storage order:
# "r1:4-0" stores bits 0..4 of r1, "r0:10-11" bit 11 then bit 10
_LAYOUTS = {
    0: "g2:4 b2:4 b3:4 r0:9-0 g0:9-0 b0:9-0 r1:4-0 g3:4 g2:3-0 g1:4-0 b3:0 "
       "g3:3-0 b1:4-0 b3:1 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    1: "g2:5 g3:4 g3:5 r0:6-0 b3:0 b3:1 b2:4 g0:6-0 b2:5 b3:2 g2:4 b0:6-0 "
       "b3:3 b3:5 b3:4 r1:5-0 g2:3-0 g1:5-0 g3:3-0 b1:5-0 b2:3-0 r2:5-0 "
       "r3:5-0",
    2: "r0:9-0 g0:9-0 b0:9-0 r1:4-0 r0:10 g2:3-0 g1:3-0 g0:10 b3:0 g3:3-0 "
       "b1:3-0 b0:10 b3:1 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    3: "r0:9-0 g0:9-0 b0:9-0 r1:3-0 r0:10 g3:4 g2:3-0 g1:4-0 g0:10 g3:3-0 "
       "b1:3-0 b0:10 b3:1 b2:3-0 r2:3-0 b3:0 b3:2 r3:3-0 g2:4 b3:3",
    4: "r0:9-0 g0:9-0 b0:9-0 r1:3-0 r0:10 b2:4 g2:3-0 g1:3-0 g0:10 b3:0 "
       "g3:3-0 b1:4-0 b0:10 b2:3-0 r2:3-0 b3:1 b3:2 r3:3-0 b3:4 b3:3",
    5: "r0:8-0 b2:4 g0:8-0 g2:4 b0:8-0 b3:4 r1:4-0 g3:4 g2:3-0 g1:4-0 b3:0 "
       "g3:3-0 b1:4-0 b3:1 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    6: "r0:7-0 g3:4 b2:4 g0:7-0 b3:2 g2:4 b0:7-0 b3:3 b3:4 r1:5-0 g2:3-0 "
       "g1:4-0 b3:0 g3:3-0 b1:4-0 b3:1 b2:3-0 r2:5-0 r3:5-0",
    7: "r0:7-0 b3:0 b2:4 g0:7-0 g2:5 g2:4 b0:7-0 g3:5 b3:4 r1:4-0 g3:4 "
       "g2:3-0 g1:5-0 g3:3-0 b1:4-0 b3:1 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    8: "r0:7-0 b3:1 b2:4 g0:7-0 b2:5 g2:4 b0:7-0 b3:5 b3:4 r1:4-0 g3:4 "
       "g2:3-0 g1:4-0 b3:0 g3:3-0 b1:5-0 b2:3-0 r2:4-0 b3:2 r3:4-0 b3:3",
    9: "r0:5-0 g3:4 b3:0 b3:1 b2:4 g0:5-0 g2:5 b2:5 b3:2 g2:4 b0:5-0 g3:5 "
       "b3:3 b3:5 b3:4 r1:5-0 g2:3-0 g1:5-0 g3:3-0 b1:5-0 b2:3-0 r2:5-0 "
       "r3:5-0",
    10: "r0:9-0 g0:9-0 b0:9-0 r1:9-0 g1:9-0 b1:9-0",
    11: "r0:9-0 g0:9-0 b0:9-0 r1:8-0 r0:10 g1:8-0 g0:10 b1:8-0 b0:10",
    12: "r0:9-0 g0:9-0 b0:9-0 r1:7-0 r0:10-11 g1:7-0 g0:10-11 b1:7-0 "
        "b0:10-11",
    13: "r0:9-0 g0:9-0 b0:9-0 r1:3-0 r0:10-15 g1:3-0 g0:10-15 b1:3-0 "
        "b0:10-15"}
# mode -> (transformed, base bits, (red, green, blue) bits of the others)
_MODES = {0: (1, 10, (5, 5, 5)), 1: (1, 7, (6, 6, 6)),
          2: (1, 11, (5, 4, 4)), 3: (1, 11, (4, 5, 4)),
          4: (1, 11, (4, 4, 5)), 5: (1, 9, (5, 5, 5)), 6: (1, 8, (6, 5, 5)),
          7: (1, 8, (5, 6, 5)), 8: (1, 8, (5, 5, 6)), 9: (0, 6, (6, 6, 6)),
          10: (0, 10, (10, 10, 10)), 11: (1, 11, (9, 9, 9)),
          12: (1, 12, (8, 8, 8)), 13: (1, 16, (4, 4, 4))}
# low 5 bits -> mode (-1: reserved)
_MODE_OF_BITS = np.array([{2: 2, 6: 3, 10: 4, 14: 5, 18: 6, 22: 7, 26: 8,
                           30: 9, 3: 10, 7: 11, 11: 12, 15: 13}.get(
                               b, b & 1 if b & 2 == 0 else -1)
                          for b in range(32)])


def _parse(layout: str) -> list[tuple[int, int]]:
    """(endpoint component, bit) of each stored bit in order; components
    r0 g0 b0 r1 ... b3 are 0-11."""
    out = []
    for name, hi, lo in re.findall(r"([rgb]\d):(\d+)(?:-(\d+))?", layout):
        comp = 3 * int(name[1]) + "rgb".index(name[0])
        a, b = int(hi), int(lo or hi)
        step = -1 if a >= b else 1
        out += [(comp, bit) for bit in range(b, a - step, -step)]
    return out


_PARSED = {m: _parse(s) for m, s in _LAYOUTS.items()}


def _sign_extend(v: np.ndarray, bits) -> np.ndarray:
    bits = np.asarray(bits)
    sign = np.int64(1) << (bits - 1)
    return (v & ((sign << 1) - 1)) - ((v & sign) << 1)


def _unquantize(v: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    if not signed:
        if bits >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << bits) - 1, 0xFFFF,
                                            ((v << 16) + 0x8000) >> bits))
    if bits >= 16:  # PIL's unsigned 16-bit storage, as it is
        return v & 0xFFFF
    x = np.abs(v)
    q = np.where(x >= (1 << (bits - 1)) - 1, 0x7FFF,
                 ((x << 15) + 0x4000) >> (bits - 1))
    q = np.where(x == 0, 0, q)
    return np.where(v < 0, -q, q)


def _to_u8(h: np.ndarray) -> np.ndarray:
    """f16 bit patterns -> PIL's 8-bit sample."""
    f = (h & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    f = np.where(np.isnan(f), 0, f)  # x86's conversion of NaN: 0
    return np.where(f < 0, 0, np.where(f > 1, 255, (
        np.clip(f, 0, 1) * np.float32(255.0)).astype(np.int64)))


def _decode_mode(blocks: np.ndarray, mode: int, signed: bool) -> np.ndarray:
    tr, base, delta = _MODES[mode]
    n = len(blocks)
    r = Bits(blocks)
    r.pos = 2 if mode < 2 else 5
    comps = np.zeros((n, 12), np.int64)
    for comp, bit in _PARSED[mode]:
        comps[:, comp] |= r.bits[:, r.pos] << bit
        r.pos += 1
    ns = 2 if mode < 10 else 1
    partition = r.take(5) if ns == 2 else np.zeros(n, np.int64)
    ep = comps.reshape(n, 4, 3)[:, :2 * ns]
    if signed:
        ep[:, 0] = _sign_extend(ep[:, 0], base)
    if signed or tr:
        ep[:, 1:] = _sign_extend(ep[:, 1:], delta)
    if tr:  # PIL leaves the sums unsigned, in SF16 too
        ep[:, 1:] = (ep[:, :1] + ep[:, 1:]) & ((1 << base) - 1)
    ep = _unquantize(ep, base, signed)
    sub, anchor = subsets_and_anchors(ns, partition)
    ib = 3 if ns == 2 else 4
    w = WEIGHTS[ib][r.indices(ib, anchor)][..., None]
    rows = np.arange(n)[:, None]
    e0, e1 = ep[rows, 2 * sub], ep[rows, 2 * sub + 1]
    v = (e0 * (64 - w) + e1 * w) >> 6
    if signed:
        mag = (np.abs(v) * 31) >> 5
        h = np.where(v < 0, mag | 0x8000, mag)
    else:
        h = (v * 31) >> 6
    px = np.full((n, 16, 4), 255, np.int64)
    px[..., :3] = _to_u8(h)
    return px


def decode_bc6h(data: bytes, width: int, height: int, signed: bool,
                where: str = "<bc6h>") -> np.ndarray:
    """BC6H blocks (left to right, top to bottom; `signed`: SF16) ->
    (height, width, 4) u8, PIL's RGB with alpha 255."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    count = bw * bh
    if len(data) < 16 * count:
        raise ValueError(f"BC6H data truncated ({len(data)} of "
                         f"{16 * count} bytes): {where}")
    blocks = np.frombuffer(data, np.uint8, 16 * count).reshape(count, 16)
    mode = _MODE_OF_BITS[blocks[:, 0] & 31]
    px = np.zeros((count, 16, 4), np.int64)
    px[..., 3] = 255
    for m in range(14):
        sel = mode == m
        if sel.any():
            px[sel] = _decode_mode(blocks[sel], m, signed)
    img = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(
        bh * 4, bw * 4, 4)
    return img[:height, :width].astype(np.uint8)
