"""BC7 block decoding without PIL, as Pillow 12.1's libImaging/BcnDecode.c
decodes it (DDS DXGI formats 97, 98 and 99; the sRGB form is read
unconverted, as PIL reads it), vectorised over the blocks of each mode.

A block's mode is the number of zero bits before its first set bit; a
block whose first byte is 0 ("reserved") decodes as opaque black, as in
PIL. Each mode fixes the subsets (1-3), the partition bits, the
rotation and index-selection bits, the endpoint precision of colour and
alpha, the p-bits (one per endpoint, or one shared by a subset's two) and
the index widths (table below). Endpoints widen to 8 bits by bit
replication after their p-bit; each pixel's subset comes from the
partition tables and its index from the index bits, where the first pixel
of each subset (the anchor) stores one bit fewer; values interpolate as
((64 - w) e0 + w e1 + 32) >> 6 with the BC7 weights. Modes 4 and 5 carry a
second index set for alpha (mode 4's selection bit swaps the two sets)
and a rotation that swaps alpha with red, green or blue.

The partition and anchor tables are the BC7 specification's; BC6H
(assets/bc6h.py) shares the first 32 two-subset partitions.
"""

from __future__ import annotations

import numpy as np

# the 64 two-subset and 64 three-subset partitions, a digit a pixel
_P2 = np.frombuffer((
    "0011001100110011000100010001000101110111011101110001001100110111"
    "0000000100010011001101110111111100010011011111110000000100110111"
    "0000000000010011001101111111111100000001011111110000000000010111"
    "0001011111111111000000001111111100001111111111110000000000001111"
    "0000100011101111011100010000000000000000100011100111001100010000"
    "0011000100000000000010001100111000000000100011000111001100110001"
    "0011000100010000000010001000110001100110011001100011011001101100"
    "0001011111101000000011111111000001110001100011100011100110011100"
    "0101010101010101000011110000111101011010010110100011001111001100"
    "0011110000111100010101011010101001101001011010010101101010100101"
    "0111001111001110000100111100100000110010010011000011101111011100"
    "0110100110010110001111001100001101100110100110010000011001100000"
    "0100111001000000001001110010000000000010011100100000010011100100"
    "0110110010010011001101101100100101100011100111000011100111000110"
    "0110110011001001011000110011100101111110100000010001100011100111"
    "0000111100110011001100111111000000100010111011100100010001110111"
).encode(), np.uint8).reshape(64, 16) - 48
_P3 = np.frombuffer((
    "0011001102212222000100112211222100002001221122110222002200110111"
    "0000000011221122001100110022002200220022111111110011001122112211"
    "0000000011112222000011111111222200001111222222220012001200120012"
    "0112011201120112012201220122012200110112112212220011200122002220"
    "0001001101121122011100112001220000001122112211220022002200221111"
    "0111011102220222000100012221222100000011012201220000110022102210"
    "0122012200110000001200121122222201101221122101100000011012211221"
    "0022110211020022011001102002222200110122012200110000200022112221"
    "0000000211221222022200220012001100110012002202220120012001200120"
    "0000111122220000012012012012012001202012120101200011220011220011"
    "0011112222000011010101012222222200000000212121210022112200221122"
    "0022001100220011022012210220122101012222222201010000212121212121"
    "0101010101012222022201110222011100021112000211120000211221122112"
    "0222011101110222000211121112000201100110011022220000000021122112"
    "0110011022222222002200110011002200221122112200220000000000002112"
    "0002000100020001022212220222122201012222222222220111201122012220"
).encode(), np.uint8).reshape(64, 16) - 48
# the anchor of subset 1 of two, and of subsets 1 and 2 of three
_A2 = np.array([15] * 16 + [
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8,
    15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15,
    15, 15, 2, 2, 15])
_A3_1 = np.array([
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3,
    6, 10, 5, 8, 8, 6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15,
    5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3])
_A3_2 = np.array([
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3,
    15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10,
    6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    3, 15, 15, 8])
WEIGHTS = {2: np.array([0, 21, 43, 64]),
           3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
           4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                        60, 64])}
# mode -> (subsets, partition bits, rotation bits, index selection bits,
# colour bits, alpha bits, p-bits per endpoint, shared p-bits, index bits,
# second index bits)
_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
          (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
          (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
          (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))


# a block's first byte -> its mode (8: reserved)
_MODE_OF_BYTE = np.array([(b & -b).bit_length() - 1 if b else 8
                          for b in range(256)])


def subsets_and_anchors(ns: int, partition: np.ndarray):
    """(n, 16) subset of each pixel and (n, 16) whether it is an anchor,
    for `ns` subsets and each block's partition number."""
    n = len(partition)
    if ns == 1:
        sub = np.zeros((n, 16), np.int64)
    else:
        sub = (_P2 if ns == 2 else _P3)[partition].astype(np.int64)
    anchor = np.zeros((n, 16), bool)
    anchor[:, 0] = True
    rows = np.arange(n)
    if ns == 2:
        anchor[rows, _A2[partition]] = True
    elif ns == 3:
        anchor[rows, _A3_1[partition]] = True
        anchor[rows, _A3_2[partition]] = True
    return sub, anchor


class Bits:
    """The blocks' bits, little-endian, read field by field at the same
    position in every block."""

    def __init__(self, blocks: np.ndarray):
        self.bits = np.unpackbits(blocks, axis=1, bitorder="little").astype(
            np.int64)
        self.pos = 0

    def take(self, nbits: int) -> np.ndarray:
        b = self.bits[:, self.pos:self.pos + nbits]
        self.pos += nbits
        return (b << np.arange(nbits)).sum(axis=1)

    def indices(self, width: int, anchor: np.ndarray) -> np.ndarray:
        """16 indices of `width` bits each, anchors one bit fewer."""
        widths = width - anchor.astype(np.int64)
        starts = self.pos + np.cumsum(widths, axis=1) - widths
        out = np.zeros(anchor.shape, np.int64)
        rows = np.arange(len(anchor))[:, None]
        for k in range(width):
            bit = self.bits[rows, np.minimum(starts + k, 127)]
            out |= np.where(k < widths, bit, 0) << k
        self.pos += 16 * width - int(anchor[0].sum())
        return out


def _widen(v: np.ndarray, bits: int) -> np.ndarray:
    v = v << (8 - bits)
    return v | (v >> bits)


def _interpolate(e0, e1, w):
    return ((64 - w) * e0 + w * e1 + 32) >> 6


def _decode_mode(blocks: np.ndarray, mode: int) -> np.ndarray:
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _MODES[mode]
    n = len(blocks)
    r = Bits(blocks)
    r.take(mode + 1)
    partition = r.take(pb)
    rotation = r.take(rb)
    selection = r.take(isb)
    ep = np.zeros((n, 2 * ns, 4), np.int64)
    for c in range(3):
        for i in range(2 * ns):
            ep[:, i, c] = r.take(cb)
    for i in range(2 * ns) if ab else ():
        ep[:, i, 3] = r.take(ab)
    cbits, abits = cb, ab
    if epb:
        for i in range(2 * ns):
            ep[:, i] = (ep[:, i] << 1) | r.take(1)[:, None]
        cbits, abits = cb + 1, ab + (1 if ab else 0)
    if spb:
        for s in range(ns):
            p = r.take(1)[:, None, None]
            ep[:, 2 * s:2 * s + 2] = (ep[:, 2 * s:2 * s + 2] << 1) | p
        cbits += 1
    ep[..., :3] = _widen(ep[..., :3], cbits)
    ep[..., 3] = _widen(ep[..., 3], abits) if ab else 255
    sub, anchor = subsets_and_anchors(ns, partition)
    idx = r.indices(ib, anchor)
    rows = np.arange(n)[:, None]
    e0, e1 = ep[rows, 2 * sub], ep[rows, 2 * sub + 1]
    cw = aw = WEIGHTS[ib][idx]
    if ib2:
        idx2 = r.indices(ib2, anchor)
        w2 = WEIGHTS[ib2][idx2]
        swap = (selection == 1)[:, None]
        cw, aw = np.where(swap, w2, cw), np.where(swap, cw, w2)
    px = np.empty((n, 16, 4), np.int64)
    px[..., :3] = _interpolate(e0[..., :3], e1[..., :3], cw[..., None])
    px[..., 3] = _interpolate(e0[..., 3], e1[..., 3], aw)
    for rot, ch in ((1, 0), (2, 1), (3, 2)):
        m = rotation == rot
        px[m, :, 3], px[m, :, ch] = px[m, :, ch], px[m, :, 3].copy()
    return px


def decode_bc7(data: bytes, width: int, height: int,
               where: str = "<bc7>") -> np.ndarray:
    """BC7 blocks (left to right, top to bottom) -> (height, width, 4) u8
    RGBA, as PIL decodes them."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    count = bw * bh
    if len(data) < 16 * count:
        raise ValueError(f"BC7 data truncated ({len(data)} of {16 * count} "
                         f"bytes): {where}")
    blocks = np.frombuffer(data, np.uint8, 16 * count).reshape(count, 16)
    mode = _MODE_OF_BYTE[blocks[:, 0]]
    px = np.zeros((count, 16, 4), np.int64)
    px[..., 3] = 255  # reserved blocks: opaque black
    for m in range(8):
        sel = mode == m
        if sel.any():
            px[sel] = _decode_mode(blocks[sel], m)
    img = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(
        bh * 4, bw * 4, 4)
    return img[:height, :width].astype(np.uint8)
