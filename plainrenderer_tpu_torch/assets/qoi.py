"""QOI ("Quite OK Image") reading and writing without PIL, as Pillow 12.1's
QoiImagePlugin.py reads and writes it.

Read: RGB (3 channels) or RGBA (any other channel count, as PIL opens
it), the six ops of the format. PIL's decoder is kept where it departs
from the reference decoder: a run does not enter its pixel in the index
(so a run at the very start leaves slot 53 empty), and an index slot never
written reads as (0, 0, 0, 0). The decode is a Python loop over the ops.

Write: RGB and RGBA byte for byte as PIL's encoder, vectorised in numpy:
its index starts with (0, 0, 0, 0) in slot 0, a pixel equal to the
previous one extends a run (flushed at 62), any other pixel is an index
op when the last such pixel with its hash equals it, else a diff, luma,
RGB or RGBA op; the header's colour space byte is 1 (linear), as PIL
writes it by default.
"""

from __future__ import annotations

import struct

import numpy as np

from . import modes

MAGIC = b"qoif"
_END = bytes((0, 0, 0, 0, 0, 0, 0, 1))


def read_qoi(buf: bytes, where: str = "<qoi>") -> np.ndarray:
    """QOI bytes -> (H, W, 4) u8, as PIL's Image.open(...).convert("RGBA")
    gives them."""
    if not buf.startswith(MAGIC) or len(buf) < 14:
        raise ValueError(f"not a QOI file: {where}")
    w, h, channels = struct.unpack_from(">IIB", buf, 4)
    modes.check_size(w, h)
    n = w * h
    if 62 * (len(buf) - 14) < n:
        # a byte gives at most 62 pixels (a run): PIL's decoder runs out
        # of data before the image is filled
        raise ValueError(f"QOI image data truncated: {where}")
    out = bytearray(4 * n)
    index = [None] * 64
    r, g, b, a = 0, 0, 0, 255
    pos, p = 14, 0
    while p < n:
        op = buf[pos]
        pos += 1
        if op == 0xFE:
            r, g, b = buf[pos], buf[pos + 1], buf[pos + 2]
            pos += 3
        elif op == 0xFF:
            r, g, b, a = buf[pos], buf[pos + 1], buf[pos + 2], buf[pos + 3]
            pos += 4
        elif op < 0x40:
            r, g, b, a = index[op] or (0, 0, 0, 0)
        elif op < 0x80:
            r = (r + (op >> 4 & 3) - 2) & 255
            g = (g + (op >> 2 & 3) - 2) & 255
            b = (b + (op & 3) - 2) & 255
        elif op < 0xC0:
            second = buf[pos]
            pos += 1
            dg = (op & 0x3F) - 32
            r = (r + dg + (second >> 4) - 8) & 255
            g = (g + dg) & 255
            b = (b + dg + (second & 15) - 8) & 255
        else:
            run = min((op & 0x3F) + 1, n - p)
            out[4 * p:4 * (p + run)] = bytes((r, g, b, a)) * run
            p += run
            continue
        index[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = (r, g, b, a)
        out[4 * p:4 * p + 4] = bytes((r, g, b, a))
        p += 1
    px = np.frombuffer(bytes(out), np.uint8).reshape(h, w, 4).copy()
    if channels == 3:
        px[..., 3] = 255
    return px


def _signed(d: np.ndarray) -> np.ndarray:
    """(d mod 256) as -128..127, PIL's _delta."""
    return ((d & 255) ^ 128) - 128


def encode_qoi(image: np.ndarray) -> bytes:
    """(H, W, 3|4) u8 -> QOI bytes as PIL's QoiEncoder writes them. Grey
    raises ValueError, as in PIL ("Unsupported QOI image mode")."""
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] not in (3, 4) or img.dtype != np.uint8:
        raise ValueError(f"Unsupported QOI image mode: {img.dtype} "
                         f"{img.shape} (QOI is written from RGB or RGBA)")
    h, w, c = img.shape
    px = np.full((h * w, 4), 255, np.int64)
    px[:, :c] = img.reshape(-1, c)
    prev = np.concatenate(([[0, 0, 0, 255]], px[:-1]))
    same = (px == prev).all(axis=1)
    # runs of pixels equal to the one before: ceil(L / 62) run ops each,
    # written before the next differing pixel's op (or at the end)
    flag = np.concatenate(([0], same.astype(np.int8), [0]))
    starts = np.nonzero(np.diff(flag) == 1)[0]
    ends = np.nonzero(np.diff(flag) == -1)[0]
    lengths = ends - starts
    n_ops = -(-lengths // 62)
    run_at = np.repeat(ends, n_ops)
    k = np.arange(run_at.size) - np.repeat(np.cumsum(n_ops) - n_ops, n_ops)
    run_len = np.minimum(62, np.repeat(lengths, n_ops) - 62 * k)
    # every other pixel: an index op where the last earlier such pixel
    # with its hash equals it (slot 0 starts as (0, 0, 0, 0))
    idx = np.nonzero(~same)[0]
    q = px[idx]
    hsh = (q[:, 0] * 3 + q[:, 1] * 5 + q[:, 2] * 7 + q[:, 3] * 11) % 64
    order = np.lexsort((idx, hsh))
    hs, qs = hsh[order], q[order]
    seen = np.zeros(idx.size, bool)
    seen[order[1:]] = (hs[1:] == hs[:-1]) & (qs[1:] == qs[:-1]).all(axis=1)
    first = np.ones(idx.size, bool)
    first[order[1:]] = hs[1:] != hs[:-1]
    is_index = seen | (first & (hsh == 0) & (q == 0).all(axis=1))
    p = prev[idx]
    dr, dg, db = (_signed(q[:, k] - p[:, k]) for k in range(3))
    same_a = q[:, 3] == p[:, 3]
    small = ((dr >= -2) & (dr < 2) & (dg >= -2) & (dg < 2) & (db >= -2)
             & (db < 2))
    dgr, dgb = _signed(dr - dg), _signed(db - dg)
    luma = (dgr >= -8) & (dgr < 8) & (dg >= -32) & (dg < 32) & (dgb >= -8) \
        & (dgb < 8)
    ops = np.zeros((idx.size, 5), np.int64)
    length = np.empty(idx.size, np.int64)
    kind = np.select([is_index, ~same_a, small, luma], [0, 1, 2, 3], 4)
    ops[kind == 0, 0] = hsh[kind == 0]
    length[kind == 0] = 1
    m = kind == 1
    ops[m, 0] = 0xFF
    ops[m, 1:] = q[m]
    length[m] = 5
    m = kind == 2
    ops[m, 0] = 0x40 | (dr[m] + 2) << 4 | (dg[m] + 2) << 2 | (db[m] + 2)
    length[m] = 1
    m = kind == 3
    ops[m, 0] = 0x80 | (dg[m] + 32)
    ops[m, 1] = (dgr[m] + 8) << 4 | (dgb[m] + 8)
    length[m] = 2
    m = kind == 4
    ops[m, 0] = 0xFE
    ops[m, 1:4] = q[m, :3]
    length[m] = 4
    runs = np.zeros((run_at.size, 5), np.int64)
    runs[:, 0] = 0xC0 | (run_len - 1)
    keys = np.concatenate((2 * run_at, 2 * idx + 1))
    chunks = np.concatenate((runs, ops))
    lens = np.concatenate((np.ones(run_at.size, np.int64), length))
    sort = np.argsort(keys, kind="stable")
    chunks, lens = chunks[sort], lens[sort]
    body = chunks[np.arange(5) < lens[:, None]].astype(np.uint8).tobytes()
    return (MAGIC + struct.pack(">IIBB", w, h, c, 1) + body + _END)
