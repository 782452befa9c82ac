"""BC1-BC5 (DXT1-DXT5, ATI1 / ATI2) block decoding without PIL, as Pillow
12.1 decodes it, vectorised over all blocks with numpy.

Two decoders with different rounding read these blocks in PIL, and both
are kept:

  - ``decode_bcn``: libImaging/BcnDecode.c, PIL's "bcn" codec (DDS,
    FTEX). 5-6-5 endpoints widen by bit replication; BC1 blends
    (2 c0 + c1) / 3 and (c0 + 2 c1) / 3 when c0 > c1, else (c0 + c1) / 2
    and transparent black, truncating; BC2 and BC3 colour blocks always
    take the four-colour mode; BC2's 4-bit alpha becomes a * 17; BC3 /
    BC4 / BC5 alpha blocks interpolate 8 values ((8 - k) a0 + (k - 1) a1)
    / 7 when a0 > a1, else 6 values / 5 with 0 and 255, truncating; BC5S
    (signed) shifts each endpoint by +128 before the same rule. BC4 gives
    one grey channel, BC5 red and green with blue 0 (BC5S: 128).
  - ``decode_blp``: BlpImagePlugin's Python decode_dxt1 / 3 / 5 (BLP2).
    Endpoints widen by a shift (no replication), blends are (2 c0 + c1)
    // 3 in every block of DXT3 and DXT5, DXT1's transparent black only
    where c0 <= c1, and the output is a flat buffer of 4 rows per block
    row at the width rounded up to 4, which PIL then reads as the image's
    rows (so a width that is not a multiple of 4 shears the picture, as
    PIL's own decode does).
"""

from __future__ import annotations

import numpy as np

_BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16}


def _blocks(data: bytes, n: int, count: int, where: str) -> np.ndarray:
    size = _BLOCK_BYTES[n]
    if len(data) < count * size:
        raise ValueError(f"BC{n} data truncated ({len(data)} of "
                         f"{count * size} bytes): {where}")
    return np.frombuffer(data, np.uint8, count * size).reshape(count, size)


def _u16(b: np.ndarray, at: int) -> np.ndarray:
    return b[:, at].astype(np.int64) | (b[:, at + 1].astype(np.int64) << 8)


def _codes(b: np.ndarray, at: int, nbytes: int, bits: int) -> np.ndarray:
    """(n, 16 or 8) codes of `bits` bits packed little-endian in
    b[:, at:at + nbytes]."""
    word = np.zeros(b.shape[0], np.uint64)
    for k in range(nbytes):
        word |= b[:, at + k].astype(np.uint64) << np.uint64(8 * k)
    shifts = np.arange(nbytes * 8 // bits, dtype=np.uint64) * np.uint64(bits)
    return ((word[:, None] >> shifts) & np.uint64((1 << bits) - 1)).astype(
        np.int64)


def _565(c: np.ndarray, replicate: bool) -> np.ndarray:
    """(n,) 5-6-5 words -> (n, 3) channels."""
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    if replicate:
        return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                         (b << 3) | (b >> 2)], -1)
    return np.stack([r << 3, g << 2, b << 3], -1)


def _colour_block(b: np.ndarray, at: int, four_colour: bool,
                  replicate: bool) -> np.ndarray:
    """(n, 16, 4) RGBA of the colour halves b[:, at:at + 8]."""
    c0, c1 = _u16(b, at), _u16(b, at + 2)
    p0, p1 = _565(c0, replicate), _565(c1, replicate)
    pal = np.empty((b.shape[0], 4, 4), np.int64)
    pal[:, 0, :3], pal[:, 1, :3] = p0, p1
    pal[:, :, 3] = 255
    four = np.ones(b.shape[0], bool) if four_colour else c0 > c1
    f = four[:, None]
    pal[:, 2, :3] = np.where(f, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    pal[:, 3, :3] = np.where(f, (p0 + 2 * p1) // 3, 0)
    pal[:, 3, 3] = np.where(four, 255, 0)
    idx = _codes(b, at + 4, 4, 2)
    return np.take_along_axis(pal, idx[..., None], 1)


def _alpha_block(b: np.ndarray, at: int, signed: bool = False) -> np.ndarray:
    """(n, 16) values of the BC3-style alpha halves b[:, at:at + 8]."""
    a0 = b[:, at].astype(np.int64)
    a1 = b[:, at + 1].astype(np.int64)
    if signed:
        a0, a1 = a0 ^ 128, a1 ^ 128
    k = np.arange(2, 8)
    eight = (((8 - k) * a0[:, None] + (k - 1) * a1[:, None]) // 7)
    six = np.concatenate([((6 - k[:4]) * a0[:, None]
                           + (k[:4] - 1) * a1[:, None]) // 5,
                          np.zeros((len(a0), 1), np.int64),
                          np.full((len(a0), 1), 255, np.int64)], 1)
    pal = np.concatenate([a0[:, None], a1[:, None],
                          np.where((a0 > a1)[:, None], eight, six)], 1)
    return np.take_along_axis(pal, _codes(b, at + 2, 6, 3), 1)


def decode_bcn(data: bytes, n: int, width: int, height: int,
               where: str = "<bcn>", signed: bool = False) -> np.ndarray:
    """BC`n` blocks (left to right, top to bottom) -> (height, width,
    bands) u8 as BcnDecode.c writes them: RGBA for BC1-BC3, grey for BC4,
    RGB for BC5 (`signed`: BC5S, whose blue is 128)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    b = _blocks(data, n, bw * bh, where)
    if n == 1:
        px = _colour_block(b, 0, False, True)
    elif n in (2, 3):
        px = _colour_block(b, 8, True, True)
        if n == 2:
            px[..., 3] = _codes(b, 0, 8, 4) * 17
        else:
            px[..., 3] = _alpha_block(b, 0)
    elif n == 4:
        px = _alpha_block(b, 0)[..., None]
    else:
        px = np.full((len(b), 16, 3), 128 if signed else 0, np.int64)
        px[..., 0] = _alpha_block(b, 0, signed)
        px[..., 1] = _alpha_block(b, 8, signed)
    c = px.shape[-1]
    img = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(
        bh * 4, bw * 4, c)
    return img[:height, :width].astype(np.uint8)


def decode_blp(data: bytes, kind: int, width: int, height: int,
               alpha: bool, where: str = "<blp>") -> np.ndarray:
    """BLP2's DXT1 (`kind` 1; RGBA with `alpha`, else RGB), DXT3 (2) or
    DXT5 (3) blocks -> the flat u8 buffer BlpImagePlugin builds: for each
    row of blocks, 4 rows of (width rounded up to 4) pixels."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    b = _blocks(data, kind, bw * bh, where)
    if kind == 1:
        px = _colour_block(b, 0, False, False)
        if not alpha:
            px = px[..., :3]
    else:
        px = _colour_block(b, 8, True, False)
        if kind == 2:
            px[..., 3] = _codes(b, 0, 8, 4) * 17
        else:
            px[..., 3] = _alpha_block(b, 0)
    c = px.shape[-1]
    return px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).astype(
        np.uint8).reshape(-1)
