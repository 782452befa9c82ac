"""Autodesk FLI / FLC animations without PIL: the first frame, as Pillow
12.1's FliImagePlugin.py opens it and libImaging/FliDecode.c decodes it.

The palette is the one PIL builds at open: a grey ramp, overwritten by
the first 256_COLOR (4, 8-bit) or COLOR (11, 6-bit values shifted left 2
and wrapped to a byte) chunk among the first frame's chunks, its packets
skipping and setting entries. The frame at offset 128 (PIL reads it
there even behind a prefix chunk, and then fails) is decoded onto a black
image, chunk by chunk:

  - BLACK (13) clears the image; COPY (16) takes width x height bytes;
  - BRUN (15): per row a count byte (ignored), then packets: a negative
    count copies that many bytes, a positive one repeats one byte; a row
    that does not end at the width fails;
  - LC (12): a first row and a row count, then per row packets of a skip,
    then a negative count (a run of one byte) or a positive one (a copy);
  - SS2 (7): a row count, then per row words: 0xC000 and above skip
    65536 - word rows, 0x8000 and above set the row's last pixel, then
    packets of a skip and a count of 2-byte words, negative for a run;
  - colour (4, 11) and postage-stamp (18) chunks are skipped; any other
    chunk, a packet past the row or the chunk's data past the frame fails.
"""

from __future__ import annotations

import struct

import numpy as np

from . import modes


def looks_like_fli(head: bytes) -> bool:
    return (len(head) >= 16 and struct.unpack_from("<H", head, 4)[0] in
            (0xAF11, 0xAF12) and struct.unpack_from("<H", head, 14)[0]
            in (0, 3))


def _palette(buf: bytes, pos: int, shift: int) -> np.ndarray:
    """FliImageFile._palette on the grey ramp."""
    pal = [(a, a, a) for a in range(256)]
    (count,) = struct.unpack_from("<H", buf, pos)
    pos += 2
    i = 0
    for _ in range(count):
        skip, n = buf[pos], buf[pos + 1]
        pos += 2
        i += skip
        s = buf[pos:pos + 3 * (n or 256)]
        pos += 3 * (n or 256)
        for k in range(0, len(s), 3):
            pal[i] = tuple((v << shift) & 255 for v in s[k:k + 3])
            if len(s[k:k + 3]) < 3:
                raise IndexError("palette entry cut short")
            i += 1
    return np.array(pal, np.uint8)


def _header(buf: bytes):
    """FliImageFile._open: (width, height, palette, frame size)."""
    s = buf[:128]
    if not (looks_like_fli(s) and s[20:22] == b"\0\0"
            and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise modes.NotThisFormat("not an FLI/FLC file")
    w, h = struct.unpack_from("<HH", s, 8)
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    try:
        pos = 128
        chunk = buf[pos:pos + 16]
        if struct.unpack_from("<H", chunk, 4)[0] == 0xF100:
            pos = 128 + struct.unpack_from("<I", chunk)[0]
            chunk = buf[pos:pos + 16]
        if struct.unpack_from("<H", chunk, 4)[0] == 0xF1FA:
            pos += 16
            size = None
            for _ in range(struct.unpack_from("<H", chunk, 6)[0]):
                if size is not None:
                    pos += size - 6
                kind = struct.unpack_from("<H", buf, pos + 4)[0]
                if kind in (4, 11):
                    palette = _palette(buf, pos + 6, 2 if kind == 11 else 0)
                    break
                (size,) = struct.unpack_from("<I", buf, pos)
                pos += 6
                if not size:
                    break
        (framesize,) = struct.unpack_from("<I", buf, 128)
    except (struct.error, IndexError) as e:
        raise modes.NotThisFormat(f"FLI header: {e}") from None
    return w, h, palette, framesize


class _Overrun(ValueError):
    pass


def _need(data: int, n: int, end: int):
    """ERR_IF_DATA_OOB: data + n past the frame's remaining bytes."""
    if data + n > end:
        raise _Overrun("chunk data past the frame")


def _brun(img, buf, data, end):
    h, w = img.shape
    for y in range(h):
        data += 1  # the packet count, ignored
        x = 0
        while x < w:
            _need(data, 2, end)
            c = buf[data]
            if c & 0x80:
                i = 256 - c
                if x + i > w:
                    break
                _need(data, i + 1, end)
                img[y, x:x + i] = np.frombuffer(buf, np.uint8, i, data + 1)
                data += i + 1
            else:
                i = c
                if x + i > w:
                    break
                img[y, x:x + i] = buf[data + 1]
                data += 2
            x += i
        if x != w:
            raise _Overrun(f"BRUN row {y} does not end at the width")


def _lc(img, buf, data, end):
    h, w = img.shape
    y, lines = struct.unpack_from("<HH", buf, data)
    ymax = y + lines
    data += 4
    while y < ymax and y < h:
        _need(data, 1, end)
        packets = buf[data]
        data += 1
        x = p = 0
        while p < packets:
            _need(data, 2, end)
            x += buf[data]
            c = buf[data + 1]
            if c & 0x80:
                i = 256 - c
                if x + i > w:
                    break
                _need(data, 3, end)
                img[y, x:x + i] = buf[data + 2]
                data += 3
            else:
                i = c
                if x + i > w:
                    break
                _need(data, 2 + i, end)
                img[y, x:x + i] = np.frombuffer(buf, np.uint8, i, data + 2)
                data += 2 + i
            x += i
            p += 1
        if p < packets:
            break
        y += 1
    if y < ymax:
        raise _Overrun("LC rows past the image or packets past a row")


def _ss2(img, buf, data, end):
    h, w = img.shape
    (lines,) = struct.unpack_from("<H", buf, data)
    data += 2
    line = y = 0
    while line < lines and y < h:
        row = y
        _need(data, 2, end)
        (packets,) = struct.unpack_from("<H", buf, data)
        data += 2
        while packets & 0x8000:
            if packets & 0x4000:
                y += 65536 - packets
                if y >= h:
                    raise _Overrun("SS2 skips past the image")
                row = y
            else:
                img[row, w - 1] = packets & 0xFF
            _need(data, 2, end)
            (packets,) = struct.unpack_from("<H", buf, data)
            data += 2
        x = p = 0
        while p < packets:
            _need(data, 2, end)
            x += buf[data]
            c = buf[data + 1]
            if c >= 128:
                _need(data, 4, end)
                i = 256 - c
                if x + 2 * i > w:
                    break
                img[row, x:x + 2 * i] = np.tile(
                    np.frombuffer(buf, np.uint8, 2, data + 2), i)
                data += 4
                x += 2 * i
            else:
                i = 2 * c
                if x + i > w:
                    break
                _need(data, 2 + i, end)
                img[row, x:x + i] = np.frombuffer(buf, np.uint8, i, data + 2)
                data += 2 + i
                x += i
            p += 1
        if p < packets:
            break
        line += 1
        y += 1
    if line < lines:
        raise _Overrun("SS2 lines past the image or packets past a row")


def read_fli(buf: bytes, where: str = "<fli>") -> np.ndarray:
    w, h, palette, framesize = _header(buf)
    if w == 0 or h == 0:
        raise modes.NotThisFormat("FLI size 0")
    modes.check_size(w, h)
    frame = buf[128:128 + framesize]
    n = len(frame)
    if n < 4 or n + n % 2 < framesize:
        raise ValueError(f"FLI frame truncated: {where}")
    if n < 8 or struct.unpack_from("<H", frame, 4)[0] != 0xF1FA:
        raise ValueError(f"FLI frame 0 is not a frame chunk: {where}")
    img = np.zeros((h, w), np.uint8)
    (chunks,) = struct.unpack_from("<H", frame, 6)
    ptr, left = 16, n - 16
    try:
        for _ in range(chunks):
            if left < 10:
                raise _Overrun("chunk header past the frame")
            kind = struct.unpack_from("<H", frame, ptr + 4)[0]
            data, end = ptr + 6, ptr + left
            if kind == 7:
                _ss2(img, frame, data, end)
            elif kind == 12:
                _lc(img, frame, data, end)
            elif kind == 13:
                img[:] = 0
            elif kind == 15:
                _brun(img, frame, data, end)
            elif kind == 16:
                if data + w * h > end:
                    raise _Overrun("COPY chunk past the frame")
                img[:] = np.frombuffer(frame, np.uint8, w * h,
                                       data).reshape(h, w)
            elif kind not in (4, 11, 18):
                raise ValueError(f"FLI chunk type {kind} is not one PIL "
                                 f"decodes: {where}")
            (advance,) = struct.unpack_from("<i", frame, ptr)
            if advance <= 0 or advance > left:
                raise _Overrun("chunk size outside the frame")
            ptr += advance
            left -= advance
    except (_Overrun, struct.error, IndexError) as e:
        raise ValueError(f"FLI frame 0 is broken ({e}): {where}") from None
    return modes.to_rgba("P", img, palette)
