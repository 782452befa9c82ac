"""PCX and DCX reading and PCX writing without PIL, as Pillow 12.1's
PcxImagePlugin.py and DcxImagePlugin.py read them (with the C decoder
PcxDecode.c) and PcxImagePlugin.py writes them (PcxEncode.c).

Read: 1 bit in 1 plane (mode 1), 1 bit in 2 or 4 planes (2- and 4-bit
palettes from the header's 16 colours), and, in version 5 files, 8 bits
in 1 plane (L, or P where the 256-colour palette at the end is not the
grey ramp) and 8 bits in 3 planes (RGB); the run-length code throughout;
a DCX file's first page. PIL's line layout is kept: the stride is
(width * bits + 7) // 8, made even when the header's differs from it,
and its planes are moved together where they are padded, bit planes by
bytes and 24-bit planes by pixels (so a 1- or 3-pixel-wide RGB file,
whose padding that count misses, reads shifted as in PIL).
What PIL refuses (other layouts, a run across a line, too little data)
raises ValueError naming it.

Write: L (version 5, 8 bits, a grey palette after the data) and RGB (3
planes), each line's planes padded to an even length, byte for byte as
PIL's encoder: runs of up to 63 equal bytes, a lone byte below 0xC0
written as itself.
"""

from __future__ import annotations

import struct

import numpy as np

from . import modes
from .modes import NotThisFormat

DCX_MAGIC = 987654321


def looks_like_pcx(head: bytes) -> bool:
    return len(head) >= 2 and head[0] == 10 and head[1] in (0, 2, 3, 5)


def looks_like_dcx(head: bytes) -> bool:
    return len(head) >= 4 and struct.unpack_from("<I", head)[0] == DCX_MAGIC


def _decode_runs(data: np.ndarray, need: int, line: int, where: str):
    """PcxDecode.c over the bytes after the header: the first `need`
    decoded bytes. A byte with its two top bits set is a count (its low
    6 bits) for the byte after it; any other byte stands for itself.
    Every run that starts in a line must end in it."""
    high = data >= 0xC0
    # every maximal stretch of high bytes starts a code (the byte before
    # it is a literal or the value of a run); inside it codes alternate
    edge = np.diff(np.concatenate(([0], high.astype(np.int8))))
    run_start = np.maximum.accumulate(np.where(edge == 1,
                                               np.arange(data.size), 0))
    is_count = high & ((np.arange(data.size) - run_start) % 2 == 0)
    is_value = np.zeros(data.size, bool)
    is_value[1:] = is_count[:-1]
    starts = np.nonzero(~is_value)[0]
    counts = np.where(is_count[starts], data[starts] & 0x3F, 1)
    values = data[np.minimum(starts + is_count[starts], data.size - 1)]
    ends = np.cumsum(counts)
    k = int(np.searchsorted(ends, need))
    if k >= starts.size or (is_count[starts[k]] and
                            starts[k] + 1 >= data.size):
        raise ValueError(f"PCX image data truncated: {where}")
    first = ends[:k + 1] - counts[:k + 1]
    cross = (first // line != (ends[:k + 1] - 1) // line) & (counts[:k + 1]
                                                            > 1)
    if cross.any():
        raise ValueError(f"PCX run crosses the end of a line (PIL: decoder "
                         f"overrun): {where}")
    return np.repeat(values[:k + 1], counts[:k + 1])[:need]


def _page(buf: bytes, at: int, where: str) -> np.ndarray:
    s = buf[at:at + 128]
    if len(s) < 128 or not looks_like_pcx(s):
        raise ValueError(f"not a PCX file: {where}")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    x1, y1 = x1 + 1, y1 + 1
    if x1 <= x0 or y1 <= y0:
        raise NotThisFormat(f"bad PCX image size: {where}")
    version, bits, planes = s[1], s[3], s[65]
    (given,) = struct.unpack_from("<H", s, 66)
    w, h = x1 - x0, y1 - y0
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = buf[-769:]
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (pal == np.arange(256)[:, None]).all():
                mode, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"PCX layout version {version}, {bits} bits in "
                         f"{planes} planes is not one PIL reads (unknown PCX "
                         f"mode): {where}")
    modes.check_size(w, h)
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    line = planes * stride
    data = np.frombuffer(buf, np.uint8, offset=at + 128)
    rows = _decode_runs(data, line * h, line, where).reshape(h, line)
    # PcxDecode.c moves the planes together: bit planes by bytes, other
    # layouts by pixels (which leaves a 1- or 3-pixel RGB line unmoved)
    span = (w + 7) // 8
    if bits == 1 and planes > 1:
        size, bands = span, planes
    else:
        size, bands = w, line // w
    step = line // bands if bands else 0
    if step > size:
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * size:(i + 1) * size] = rows[:, i * step:
                                                   i * step + size]
    if mode == "RGB":
        return modes.to_rgba("RGB", rows[:, :3 * w].reshape(h, 3, w)
                             .transpose(0, 2, 1))
    if mode in ("L", "P") and bits == 8:
        return modes.to_rgba(mode, rows[:, :w], palette)
    # 1 bit in `planes` planes of (w + 7) // 8 bytes (Unpack.c 1 and
    # P;2L / P;4L read the planes at that spacing)
    bit = np.unpackbits(rows[:, :planes * span].reshape(h, planes, span),
                        axis=2)[..., :w]
    if mode == "1":
        return modes.to_rgba("1", bit[:, 0])
    index = (bit * (1 << np.arange(planes))[None, :, None]).sum(axis=1)
    return modes.to_rgba("P", index.astype(np.uint8), palette)


def read_pcx(buf: bytes, where: str = "<pcx>") -> np.ndarray:
    """PCX bytes -> (H, W, 4) u8, as PIL's Image.open(...).convert("RGBA")
    gives them."""
    return _page(buf, 0, where)


def read_dcx(buf: bytes, where: str = "<dcx>") -> np.ndarray:
    """DCX bytes -> its first page, as PIL opens it."""
    if not looks_like_dcx(buf) or len(buf) < 8:
        raise ValueError(f"not a DCX file: {where}")
    (first,) = struct.unpack_from("<I", buf, 4)
    if not first:
        raise ValueError(f"DCX file without pages: {where}")
    return _page(buf, first, where)


def _encode_lines(segs: np.ndarray, pad: int) -> bytes:
    """PcxEncode.c on (n, length) byte segments (each plane of each line):
    runs of equal bytes cut at 63 and coded as 0xC0 | count and the byte,
    a run of one byte below 0xC0 as the byte alone; `pad` zero bytes after
    every segment."""
    n, length = segs.shape
    flat = segs.reshape(-1).astype(np.int64)
    new = np.ones(flat.size, bool)
    new[1:] = flat[1:] != flat[:-1]
    new[::length] = True
    starts = np.nonzero(new)[0]
    run = np.diff(np.append(starts, flat.size))
    pieces = -(-run // 63)
    at = np.repeat(starts, pieces)
    k = np.arange(at.size) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    count = np.minimum(63, np.repeat(run, pieces) - 63 * k)
    value = flat[at]
    lone = (count == 1) & (value < 0xC0)
    code = np.stack([np.where(lone, value, 0xC0 | count), value], axis=1)
    width = np.where(lone, 1, 2)
    seg = at // length
    keys = seg * 2
    chunks, widths = code, width
    if pad:
        chunks = np.concatenate((code, np.zeros((n, 2), np.int64)))
        widths = np.concatenate((width, np.full(n, 1)))
        keys = np.concatenate((keys, 2 * np.arange(n) + 1))
    order = np.argsort(keys, kind="stable")
    chunks, widths = chunks[order], widths[order]
    return chunks[np.arange(2) < widths[:, None]].astype(np.uint8).tobytes()


def encode_pcx(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) u8 -> PCX bytes as PIL's _save writes modes L
    and RGB. RGBA raises ValueError, as in PIL."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 4:
        raise ValueError("Cannot save RGBA images as PCX")
    h, w = img.shape[:2]
    planes = 1 if img.ndim == 2 else 3
    stride = w + w % 2
    head = (bytes((10, 5, 1, 8)) + struct.pack("<HHHHHH", 0, 0, w - 1, h - 1,
                                               100, 100)
            + bytes(24) + b"\xff" * 24 + b"\0" + bytes((planes,))
            + struct.pack("<HHHH", stride, 1, w, h) + bytes(54))
    segs = img.reshape(h, w, planes).transpose(0, 2, 1).reshape(h * planes, w)
    body = _encode_lines(segs, w % 2)
    if planes == 1:
        body += b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8),
                                    3).tobytes()
    return head + body
