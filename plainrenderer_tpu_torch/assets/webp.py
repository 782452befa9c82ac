"""WebP reading without PIL: the RIFF container and its first frame, as
Pillow 12.1 reads it. Pillow decodes every WebP file, a still one too,
through libwebp 1.6's animation decoder (src/demux/anim_decode.c
``WebPAnimDecoderGetNext``, colour mode MODE_RGBA, no threads), which runs
``WebPDecode`` with the default options (fancy upsampling on, no
dithering, the loop filter on) into a canvas it first fills with
transparent black. Pillow's mode is RGBA when the file has alpha and RGB
otherwise (``WebPGetFeatures``: VP8X's alpha flag, VP8L's alpha_is_used
bit; never for a plain VP8 chunk), so without alpha the result's alpha is
255.

Covered: simple lossy (``VP8 ``, assets/vp8.py) and lossless (``VP8L``,
assets/vp8l.py) files; the extended format (``VP8X``) with an ``ALPH``
chunk (raw or VP8L-compressed alpha; the horizontal, vertical and
gradient filters of src/dsp/filters.c undone row by row) and with ICCP,
EXIF and XMP chunks skipped; an animation's (``ANIM``) first ``ANMF``
frame placed at its offset on the canvas. Later frames are not read.
"""

from __future__ import annotations

import struct

import numpy as np

from . import modes, vp8, vp8l


def _chunks(buf: bytes, pos: int, end: int, where: str):
    while pos + 8 <= end:
        tag = buf[pos:pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        body = buf[pos + 8:pos + 8 + size]
        if len(body) < size:
            raise ValueError(f"WebP chunk {tag!r} truncated: {where}")
        yield tag, body
        pos += 8 + size + (size & 1)


def _unfilter_alpha(a: np.ndarray, method: int) -> np.ndarray:
    """src/dsp/filters.c: undo the ALPH filter (1 horizontal, 2 vertical,
    3 gradient) row by row; the first row of each is horizontal."""
    if method == 0:
        return a
    h, w = a.shape
    out = np.empty_like(a)
    for y in range(h):
        row = a[y].astype(np.int64)
        if y == 0 or method == 1:
            pred0 = 0 if y == 0 else int(out[y - 1, 0])
            out[y] = (np.cumsum(row) + pred0) & 255
        elif method == 2:
            out[y] = (row + out[y - 1]) & 255
        else:
            prev = out[y - 1].astype(np.int64)
            left = int(prev[0])
            top_left = left
            vals = np.empty(w, np.uint8)
            for x in range(w):
                top = int(prev[x])
                g = left + top - top_left
                g = g if 0 <= g <= 255 else (0 if g < 0 else 255)
                left = (int(row[x]) + g) & 255
                top_left = top
                vals[x] = left
            out[y] = vals
    return out


def _alpha(chunk: bytes, w: int, h: int, where: str) -> np.ndarray:
    """An ALPH chunk -> (h, w) u8 alpha (src/dec/alpha_dec.c)."""
    if not chunk:
        raise ValueError(f"WebP ALPH chunk is empty: {where}")
    head = chunk[0]
    method, filt, pre, rsrv = head & 3, (head >> 2) & 3, (head >> 4) & 3, \
        head >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError(f"WebP ALPH header {head:#x} is not valid: {where}")
    data = chunk[1:]
    if method == 0:
        if len(data) < w * h:
            raise ValueError(f"WebP raw alpha truncated: {where}")
        a = np.frombuffer(data, np.uint8, w * h).reshape(h, w)
    else:
        px = vp8l.decode_image_stream(data, w, h)
        a = ((np.asarray(px, np.uint32) >> 8) & 255).astype(
            np.uint8).reshape(h, w)
    return _unfilter_alpha(a, filt)


def _frame(chunks: list, where: str) -> np.ndarray:
    """A frame's ALPH / VP8 / VP8L chunks -> (H, W, 4) u8 RGBA."""
    alph = next((b for t, b in chunks if t == b"ALPH"), None)
    for tag, body in chunks:
        if tag == b"VP8L":
            argb = vp8l.decode_argb(body)
            out = np.empty(argb.shape + (4,), np.uint8)
            for k, s in enumerate((16, 8, 0, 24)):
                out[..., k] = (argb >> s) & 255
            return out
        if tag == b"VP8 ":
            rgb = vp8.decode_rgb(body, where)
            h, w = rgb.shape[:2]
            out = np.full((h, w, 4), 255, np.uint8)
            out[..., :3] = rgb
            if alph is not None:
                out[..., 3] = _alpha(alph, w, h, where)
            return out
    raise ValueError(f"WebP frame without VP8 or VP8L data: {where}")


def read_webp(buf: bytes, where: str = "<webp>") -> np.ndarray:
    """WebP bytes -> (H, W, 4) u8 of the first frame, as PIL's
    Image.open(...).convert("RGBA") gives them."""
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WEBP":
        raise ValueError(f"not a WebP file: {where}")
    (riff_size,) = struct.unpack_from("<I", buf, 4)
    end = min(len(buf), 8 + riff_size)
    chunks = list(_chunks(buf, 12, end, where))
    if not chunks:
        raise ValueError(f"WebP without chunks: {where}")
    tag0, body0 = chunks[0]
    if tag0 == b"VP8L":
        w, h, has_alpha = vp8l.read_header(body0)
        modes.check_size(w, h)
        img = _frame(chunks[:1], where)
    elif tag0 == b"VP8 ":
        has_alpha = False
        if len(body0) >= 10:
            modes.check_size(*(int.from_bytes(body0[k:k + 2], "little")
                               & 0x3FFF for k in (6, 8)))
        img = _frame(chunks[:1], where)
    elif tag0 == b"VP8X":
        if len(body0) < 10:
            raise ValueError(f"WebP VP8X chunk truncated: {where}")
        flags = body0[0]
        has_alpha = bool(flags & 0x10)
        cw = int.from_bytes(body0[4:7], "little") + 1
        ch = int.from_bytes(body0[7:10], "little") + 1
        modes.check_size(cw, ch)
        if flags & 0x02:  # animation: the first ANMF frame
            anmf = next((b for t, b in chunks if t == b"ANMF"), None)
            if anmf is None or len(anmf) < 16:
                raise ValueError(f"WebP animation without a frame: {where}")
            x0 = 2 * int.from_bytes(anmf[0:3], "little")
            y0 = 2 * int.from_bytes(anmf[3:6], "little")
            fw = int.from_bytes(anmf[6:9], "little") + 1
            fh = int.from_bytes(anmf[9:12], "little") + 1
            frame = _frame(list(_chunks(anmf, 16, len(anmf), where)), where)
            if frame.shape[:2] != (fh, fw) or x0 + fw > cw or y0 + fh > ch:
                raise ValueError(f"WebP frame does not fit its canvas: "
                                 f"{where}")
            img = np.zeros((ch, cw, 4), np.uint8)
            img[y0:y0 + fh, x0:x0 + fw] = frame
        else:
            img = _frame(chunks[1:], where)
            if img.shape[:2] != (ch, cw):
                raise ValueError(f"WebP image size differs from its VP8X "
                                 f"canvas: {where}")
    else:
        raise ValueError(f"WebP first chunk {tag0!r} is not VP8, VP8L or "
                         f"VP8X: {where}")
    if not has_alpha:
        img[..., 3] = 255
    return img
