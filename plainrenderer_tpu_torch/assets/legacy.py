"""PIL's small legacy formats without PIL: XBM, XPM, PIXAR, XV thumbnails,
IM Tools (IMT), McIdas areas, GIMP brushes (GBR), Windows Paint (MSP) and
Sun rasters, each as Pillow 12.1's plugin (``<Name>ImagePlugin.py``) and
its C decoder read it, converted as ``Image.convert("RGBA")`` does:

  - XBM: PIL's header pattern over the first 512 bytes, then
    XbmDecode.c: every 'x' starts a byte of the next two characters read
    as hex digits (anything else is 0), rows padded to bytes, bits least
    significant first, a set bit white (raw mode 1;R);
  - XPM: the header line, one palette line per colour (``c #rrggbb`` or
    ``c None``, which PIL stores as the transparency: the key's bytes
    become the alphas of the first palette entries); palette mode up to
    256 colours, RGB beyond; the pixel lines' quoted text cut into keys
    of chars-per-pixel characters and read as one stream;
  - PIXAR: 8-bit RGB (the only layout PIL reads) at offset 1024;
  - XVThumb: "P7 332", comment lines, the size line, 3-3-2 palette
    indices;
  - IMT: PIL's line parser ("width", "height", "pixel n8"), the pixels
    after a form feed;
  - McIdas: 8-, 16- (big-endian) and 32-bit (big-endian, signed) areas,
    each line behind its prefix;
  - GBR: versions 1 and 2, grey (1 byte) or RGBA (4 bytes) brushes;
  - MSP: version 1 raw bits, version 2 run-length rows (MspDecoder, rows
    of length 0 white);
  - Sun: 1-bit (set bits black), 4- and 8-bit grey or palette (a
    palette of type 1 makes a grey image a palette image), 24- and 32-bit
    BGR(X), or RGB(X) where the file type is 3; raw rows padded to 16
    bits, or type 2's run-length stream (SunRleDecode.c: rows of the
    unpadded width, runs running on across rows).

Each reader raises modes.NotThisFormat where PIL's ``_open`` raises
SyntaxError (Image.open then tries the next format) and ValueError where
PIL fails otherwise.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from . import modes

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")
_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789abcdefABCDEF":
    _HEX[_c] = int(chr(_c), 16)
# XVThumb's 3-3-2 palette
XV_PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                       for r in range(8) for g in range(8) for b in range(4)],
                      np.uint8)


def _positive(w: int, h: int):
    """ImageFile's check after _open: a size of 0 is not this format;
    then Image.open's decompression-bomb check."""
    if w <= 0 or h <= 0:
        raise modes.NotThisFormat(f"size {w}x{h}")
    modes.check_size(w, h)


# -------------------------------- XBM --------------------------------

def looks_like_xbm(head: bytes) -> bool:
    return head.lstrip().startswith(b"#define")


def read_xbm(buf: bytes, where: str = "<xbm>") -> np.ndarray:
    m = _XBM_HEAD.match(buf[:512])
    if not m:
        raise modes.NotThisFormat("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    _positive(w, h)
    stride = (w + 7) // 8
    text = np.frombuffer(buf, np.uint8, offset=m.end())
    xs = np.flatnonzero(text == ord("x"))
    if xs.size > 1 and (np.diff(xs) < 3).any():
        # an 'x' inside the two digits of another: take them in order
        keep, last = [], -3
        for x in xs.tolist():
            if x >= last + 3:
                keep.append(x)
                last = x
        xs = np.asarray(keep, np.int64)
    xs = xs[xs + 2 < text.size]  # a byte needs both digits in the file
    if xs.size < stride * h:
        raise ValueError(f"XBM data truncated ({xs.size} of {stride * h} "
                         f"bytes): {where}")
    xs = xs[:stride * h]
    data = (_HEX[text[xs + 1]] << 4) | _HEX[text[xs + 2]]
    return modes.to_rgba("1", modes.raw(data.tobytes(), 0, "1;R", w, h,
                                        where=where))


# -------------------------------- XPM --------------------------------

def _lines(buf: bytes, pos: int):
    """readline() from pos on: (line with its newline, next pos)."""
    end = buf.find(b"\n", pos)
    end = len(buf) if end < 0 else end + 1
    return buf[pos:end], end


def read_xpm(buf: bytes, where: str = "<xpm>") -> np.ndarray:
    if not buf.startswith(b"/* XPM */"):
        raise modes.NotThisFormat("not an XPM file")
    pos = 9
    while True:
        line, pos = _lines(buf, pos)
        if not line:
            raise modes.NotThisFormat("broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, n_colours, cpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"XPM header {line!r} is not four numbers: "
                         f"{where}") from None
    palette, transparency = {}, None
    for _ in range(n_colours):
        line, pos = _lines(buf, pos)
        line = line.rstrip()
        key, fields = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(fields), 2):
            if fields[i] == b"c":
                if i + 1 >= len(fields):
                    raise modes.NotThisFormat("XPM colour without a value")
                rgb = fields[i + 1]
                if rgb == b"None":
                    transparency = key
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError(f"XPM colour {rgb!r} is not #rrggbb or "
                                     f"None (PIL: cannot read): {where}")
                break
        else:
            raise ValueError(f"XPM palette line {line!r} has no colour: "
                             f"{where}")
    _positive(w, h)
    rgb_mode = n_colours > 256
    index = {k: i for i, k in enumerate(palette)}
    keys = []
    pixel_header = False
    while len(keys) < w * h:
        line, pos = _lines(buf, pos)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        keys.extend(text[i:i + cpp] for i in range(0, len(text), cpp))
    try:
        if rgb_mode:
            px = np.array([palette[k] for k in keys], np.uint8)
        else:
            px = np.array([index[k] for k in keys], np.uint8)
    except KeyError as e:
        raise ValueError(f"XPM pixel key {e.args[0]!r} is not in the "
                         f"palette: {where}") from None
    if len(keys) < w * h:
        raise ValueError(f"XPM pixel data truncated: {where}")
    if rgb_mode:
        if transparency is not None:
            raise ValueError(f"XPM: PIL cannot apply the transparent key "
                             f"{transparency!r} of an RGB image: {where}")
        return modes.to_rgba("RGB", px[:w * h].reshape(h, w, 3))
    table = np.array(list(palette.values()), np.uint8).reshape(-1, 3)
    return modes.to_rgba("P", px[:w * h].reshape(h, w), table,
                         None if transparency is None
                         else bytes(transparency))


# ----------------------------- PIXAR, XV -----------------------------

def read_pixar(buf: bytes, where: str = "<pxr>") -> np.ndarray:
    if len(buf) < 428 or not buf.startswith(b"\x80\xe8\x00\x00"):
        raise modes.NotThisFormat("not a PIXAR file")
    h, w = struct.unpack_from("<HH", buf, 416)
    layout = struct.unpack_from("<HH", buf, 424)
    if layout != (14, 2):
        raise modes.NotThisFormat("PIXAR layout PIL does not read")
    _positive(w, h)
    return modes.to_rgba("RGB", modes.raw(buf, 1024, "RGB", w, h,
                                          where=where))


def read_xvthumb(buf: bytes, where: str = "<xv>") -> np.ndarray:
    if not buf.startswith(b"P7 332"):
        raise modes.NotThisFormat("not an XV thumbnail file")
    _, pos = _lines(buf, 6)
    while True:
        line, pos = _lines(buf, pos)
        if not line:
            raise modes.NotThisFormat("XV thumbnail ends in its header")
        if line[0] != 35:  # '#'
            break
    size = line.strip().split(maxsplit=2)[:2]
    try:
        w, h = int(size[0]), int(size[1])
    except (IndexError, ValueError):
        raise ValueError(f"XV thumbnail size line {line!r}: "
                         f"{where}") from None
    _positive(w, h)
    return modes.to_rgba("P", modes.raw(buf, pos, "P", w, h, where=where),
                         XV_PALETTE)


# -------------------------------- IMT --------------------------------

def read_imt(buf: bytes, where: str = "<imt>") -> np.ndarray:
    """ImtImageFile._open's loop, transliterated: its buffer of 100-byte
    reads decides where the pixels start."""
    buffer, pos = buf[:100], min(100, len(buf))
    if b"\n" not in buffer:
        raise modes.NotThisFormat("not an IM Tools file")
    size, mode, offset = (0, 0), "", None
    xsize = ysize = 0
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = buf[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            more = buf[pos:pos + 100]
            buffer += more
            pos += len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
                size = xsize, ysize
            elif k == b"height":
                ysize = int(v)
                size = xsize, ysize
        except ValueError:
            raise ValueError(f"IMT {k.decode()} {v!r} is not a number: "
                             f"{where}") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode:
        raise modes.NotThisFormat("IM Tools file without pixel n8")
    _positive(*size)
    if offset is None:
        raise ValueError(f"IM Tools header without pixels (PIL: cannot load "
                         f"this image): {where}")
    return modes.to_rgba("L", modes.raw(buf, offset, "L", *size,
                                        where=where))


# ------------------------------- McIdas ------------------------------

def read_mcidas(buf: bytes, where: str = "<mcidas>") -> np.ndarray:
    if len(buf) < 256 or not buf.startswith(b"\0\0\0\0\0\0\0\x04"):
        raise modes.NotThisFormat("not an McIdas area file")
    w = (0,) + struct.unpack_from(">64i", buf)
    kinds = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}
    if w[11] not in kinds:
        raise modes.NotThisFormat("unsupported McIdas format")
    mode, rawmode = kinds[w[11]]
    _positive(w[10], w[9])
    stride = w[15] + w[10] * w[11] * w[14]
    return modes.to_rgba(mode, modes.raw(buf, w[34] + w[15], rawmode, w[10],
                                         w[9], stride, where=where))


# -------------------------------- GBR --------------------------------

def looks_like_gbr(head: bytes) -> bool:
    return (len(head) >= 8 and struct.unpack_from(">I", head)[0] >= 20
            and struct.unpack_from(">I", head, 4)[0] in (1, 2))


def read_gbr(buf: bytes, where: str = "<gbr>") -> np.ndarray:
    try:
        hsize, version, w, h, depth = struct.unpack_from(">5I", buf)
    except struct.error:
        raise modes.NotThisFormat("GIMP brush header truncated") from None
    if hsize < 20 or version not in (1, 2) or w == 0 or h == 0 \
            or depth not in (1, 4):
        raise modes.NotThisFormat("not a GIMP brush PIL reads")
    if version == 2 and buf[20:24] != b"GIMP":
        raise modes.NotThisFormat("not a GIMP brush, bad magic number")
    for _ in range(2):      # GbrImageFile._open checks, then Image.open
        modes.check_size(w, h)
    n = w * h * depth
    data = buf[hsize:hsize + n]
    if len(data) < n:
        raise ValueError(f"GIMP brush data truncated (PIL: not enough image "
                         f"data): {where}")
    px = np.frombuffer(data, np.uint8).reshape(h, w, depth)
    return modes.to_rgba("L" if depth == 1 else "RGBA",
                         px[..., 0] if depth == 1 else px)


# -------------------------------- MSP --------------------------------

def read_msp(buf: bytes, where: str = "<msp>") -> np.ndarray:
    if len(buf) < 32 or not buf.startswith((b"DanM", b"LinS")):
        raise modes.NotThisFormat("not an MSP file")
    words = struct.unpack_from("<16H", buf)
    check = 0
    for v in words:
        check ^= v
    if check:
        raise modes.NotThisFormat("bad MSP checksum")
    w, h = words[2], words[3]
    _positive(w, h)
    if buf.startswith(b"DanM"):
        return modes.to_rgba("1", modes.raw(buf, 32, "1", w, h, where=where))
    if len(buf) < 32 + 2 * h:
        raise ValueError(f"MSP row map truncated: {where}")
    rowmap = struct.unpack_from(f"<{h}H", buf, 32)
    blank = b"\xff" * ((w + 7) // 8)
    out, pos = [], 32 + 2 * h
    for y, n in enumerate(rowmap):
        if n == 0:
            out.append(blank)
            continue
        row = buf[pos:pos + n]
        pos += n
        if len(row) != n:
            raise ValueError(f"MSP row {y} truncated: {where}")
        i = 0
        while i < n:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > n:
                    raise ValueError(f"MSP row {y} corrupted: {where}")
                out.append(row[i + 1:i + 2] * row[i])
                i += 2
            else:
                out.append(row[i:i + kind])
                i += kind
    return modes.to_rgba("1", modes.raw(b"".join(out), 0, "1", w, h,
                                        where=where))


# -------------------------------- Sun --------------------------------

def _sun_rle(buf: bytes, pos: int, need: int, where: str) -> bytes:
    """SunRleDecode.c's byte stream: 0x80 0 is a literal 0x80, 0x80 n v a
    run of n + 1 v, any other byte itself; the first `need` bytes."""
    vals, counts, total = [], [], 0
    while total < need:
        at = buf.find(b"\x80", pos)
        stop = len(buf) if at < 0 else at
        if stop > pos:  # literal bytes up to the next marker
            take = min(stop - pos, need - total)
            vals.append(np.frombuffer(buf, np.uint8, take, pos))
            counts.append(np.ones(take, np.int64))
            total += take
            pos += take
            continue
        if at < 0 or at + 1 >= len(buf):
            break
        n = buf[at + 1]
        if n == 0:
            vals.append(np.array([0x80], np.uint8))
            counts.append(np.array([1]))
            total, pos = total + 1, at + 2
        else:
            if at + 2 >= len(buf):
                break
            vals.append(np.array([buf[at + 2]], np.uint8))
            counts.append(np.array([n + 1]))
            total, pos = total + n + 1, at + 3
    if total < need:
        raise ValueError(f"Sun run-length data truncated: {where}")
    return np.repeat(np.concatenate(vals), np.concatenate(counts))[
        :need].tobytes()


def read_sun(buf: bytes, where: str = "<ras>") -> np.ndarray:
    if len(buf) < 32 or not buf.startswith(b"\x59\xa6\x6a\x95"):
        raise modes.NotThisFormat("not a Sun raster file")
    _, w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">8I", buf)
    rgb_order = ftype == 3
    layouts = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
               24: ("RGB", "RGB" if rgb_order else "BGR"),
               32: ("RGB", "RGBX" if rgb_order else "BGRX")}
    if depth not in layouts:
        raise modes.NotThisFormat("unsupported Sun raster depth")
    mode, rawmode = layouts[depth]
    offset, palette = 32, None
    if plen:
        if plen > 1024 or ptype != 1:
            raise modes.NotThisFormat("unsupported Sun raster palette")
        pal = np.frombuffer(buf[32:32 + plen], np.uint8)
        n = len(pal) // 3
        palette = pal[:3 * n].reshape(3, n).T  # "RGB;L": planar
        offset += plen
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise modes.NotThisFormat("unsupported Sun raster file type")
    _positive(w, h)
    if ftype == 2:
        row = (w * depth + 7) // 8
        data = _sun_rle(buf, offset, row * h, where)
        px = modes.raw(data, 0, rawmode, w, h, where=where)
    else:
        px = modes.raw(buf, offset, rawmode, w, h,
                       ((w * depth + 15) // 16) * 2, where=where)
    return modes.to_rgba(mode, px, palette)
