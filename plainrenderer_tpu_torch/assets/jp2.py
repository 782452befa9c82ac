"""JPEG 2000 files (J2K codestreams and JP2 / JPX files) -> RGBA, as PIL
12.1's Jpeg2KImagePlugin and its C decoder over OpenJPEG 2.5.4 give them.

What PIL does, and so what this module does:

  - the mode and size come from PIL's own header parse: for a codestream,
    SIZ's size and component count (1: L, or I;16 above 8 bits; 2: LA;
    3: RGB; 4: RGBA; anything else is refused); for a JP2 file, the boxes
    after the signature up to ``jp2h``, then ``ihdr`` (the same modes by
    NC and BPC), ``colr`` method 1 with EnumCS 12 on four components
    (CMYK), ``pclr`` on L / LA with entries of at most 8 bits (P / PA, the
    palette built entry by entry through ImagePalette.getcolor, which
    merges repeated colours, so later indices shift);
  - OpenJPEG reads the JP2 boxes itself (jp2.c: signature, ftyp, jp2h with
    ihdr, colr, bpcc, pclr, cmap, cdef, their size checks), takes the
    colour space from the first ``colr`` (16 sRGB, 17 grey, 18 sYCC, 24
    eYCC, 12 CMYK, anything else unknown), requires SIZ's size to be
    ihdr's, and decodes the codestream tile by tile (j2k_codestream,
    j2k_t2, j2k_t1, j2k_recon); PIL's tile API never applies pclr, cmap
    or cdef;
  - PIL's decoder picks an unpacker by mode, component count and colour
    space (an unspecified or unknown space, as a codestream's, an ICC
    profile's or an unlisted EnumCS, is grey for 1-2 components and sRGB
    for 3-4, and sYCC when only components after the first are
    subsampled), and unpacks each tile: every
    sample shifted to 8 bits (16 for I;16) from its precision, signed
    samples offset by half their range, a rounding half added before a
    right shift, subsampled components placed nearest-neighbour by
    integer division of the tile's own coordinates, with PIL's row and
    plane strides (tile width // dx), and sYCC converted row by row by
    ImagingConvertYCbCr2RGB;
  - ``convert("RGBA")`` through modes.to_rgba (I;16 clipped at 255,
    PIL's CMYK formula, the palette's entries).

A tile that does not fit the image PIL allocated, a component count that
differs from the mode's, or anything OpenJPEG refuses raises ValueError,
where PIL raises OSError.

``encode_jp2`` writes what PIL's default JPEG 2000 save writes under any
suffix but .j2k: the codestream of j2k_encode in OpenJPEG's JP2 boxes
(jp2.c): the signature, ``ftyp`` (brand ``jp2 ``, minor version 0, one
compatible brand ``jp2 ``), ``jp2h`` holding ``ihdr`` (8-bit unsigned
components, compression type 7, no unknown colour space, no IPR) and
``colr`` (method 1, enumerated sRGB for RGB and RGBA, greyscale for L),
with ``cdef`` for RGBA (the three colours, then channel 3 as the opacity
of the whole image), then ``jp2c``."""

from __future__ import annotations

import struct

import numpy as np

from . import modes
from .j2k_codestream import Codestream, J2kError
from .j2k_encode import encode_j2k
from .j2k_recon import decode_tile

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
# OpenJPEG's colour spaces
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}
# Jpeg2KDecode.c's unpackers: (mode, colour space, components) -> (kind,
# takes subsampled components)
_UNPACKERS = {
    ("L", GRAY, 1): ("l", False), ("P", SRGB, 1): ("l", False),
    ("PA", SRGB, 2): ("la", False), ("I;16", GRAY, 1): ("i16", False),
    ("LA", GRAY, 2): ("la", False), ("RGB", GRAY, 1): ("grey_rgb", False),
    ("RGB", GRAY, 2): ("grey_rgb", False), ("RGB", SRGB, 3): ("rgb", True),
    ("RGB", SYCC, 3): ("ycc", True), ("RGB", SRGB, 4): ("rgb", True),
    ("RGB", SYCC, 4): ("ycc", True), ("RGBA", GRAY, 1): ("grey_rgb", False),
    ("RGBA", GRAY, 2): ("la", False), ("RGBA", SRGB, 3): ("rgb", True),
    ("RGBA", SYCC, 3): ("ycc", True), ("RGBA", SRGB, 4): ("rgba", True),
    ("RGBA", GRAY, 4): ("rgba", True),
    ("RGBA", SYCC, 4): ("ycca", True), ("CMYK", CMYK, 4): ("rgba", True)}


class _Boxes:
    """PIL's BoxReader over bytes: (type, body start, body end) steps."""

    def __init__(self, data: bytes, start: int, end):
        self.data, self.pos, self.end = data, start, end

    def next(self):
        if self.end is not None and self.pos + 8 > self.end:
            raise modes.NotThisFormat("Not enough data in header")
        if self.pos + 8 > len(self.data):
            raise ValueError("JP2 box header truncated")
        lbox, tbox = struct.unpack_from(">I4s", self.data, self.pos)
        hlen = 8
        if lbox == 1:
            if (self.end is not None and self.pos + 16 > self.end) \
                    or self.pos + 16 > len(self.data):
                raise ValueError("JP2 box header truncated")
            (lbox,) = struct.unpack_from(">Q", self.data, self.pos + 8)
            hlen = 16
        if lbox < hlen or (self.end is not None and self.pos + lbox > self.end):
            raise modes.NotThisFormat("Invalid header length")
        start = self.pos + hlen
        self.pos += lbox
        return tbox, start, self.pos


def _pil_jp2_header(data: bytes):
    """Jpeg2KImagePlugin._parse_jp2_header: (size, mode, palette bytes,
    palette mode)."""
    top = _Boxes(data, 12, None)
    while True:
        tbox, s, e = top.next()
        if e > len(data):
            raise ValueError("JP2 box runs past the end of the file")
        if tbox == b"jp2h":
            break
    header = _Boxes(data, s, e)
    size = mode = None
    nc = None
    palette = None
    while header.pos < header.end:
        tbox, s, e = header.next()
        body = data[s:e]

        def fields(fmt):
            n = struct.calcsize(fmt)
            if n > len(body):
                raise modes.NotThisFormat("Not enough data in header")
            return struct.unpack_from(fmt, body)

        if tbox == b"ihdr":
            height, width, nc, bpc = fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _p, _a, enumcs = fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = fields(">HB")
            depths = fields(">HB" + "B" * npc)[2:]
            if max(depths, default=0) <= 8:
                palette = _getcolor_palette(body, ne, npc)
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise modes.NotThisFormat("Malformed JP2 header")
    return size, mode, palette


def _getcolor_palette(body: bytes, ne: int, npc: int):
    """The palette ImagePalette.getcolor builds from the entries, in
    order: (raw bytes, "RGB" or "RGBA")."""
    pmode = "RGBA" if npc == 4 else "RGB"
    pal = bytearray()
    colors: dict = {}
    pos = 3 + npc
    for _ in range(ne):
        if pos + npc > len(body):
            raise modes.NotThisFormat("Not enough data in header")
        color = tuple(body[pos:pos + npc])
        pos += npc
        if pmode == "RGB" and len(color) == 4:
            color = color[:3]
        elif pmode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in colors:
            continue
        step = len(pmode)
        index = len(pal) // step
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        colors[color] = index
        if index * step < len(pal):
            pal = pal[:index * step] + bytes(color) + pal[index * step + step:]
        else:
            pal += bytes(color)
    return bytes(pal), pmode


def _opj_jp2(data: bytes):
    """jp2.c's box reading up to the codestream: (colour space, (w, h)
    from ihdr, codestream offset)."""
    pos = 0
    state = 0  # 1 signature, 2 ftyp, 4 header
    ihdr = None
    colour = UNKNOWN
    has_colr = False
    while True:
        if pos + 8 > len(data):
            raise J2kError("JP2 file without a codestream box")
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 0:
            lbox = len(data) - pos
        elif lbox == 1:
            if pos + 16 > len(data):
                raise J2kError("JP2 box header truncated")
            hi, lbox = struct.unpack_from(">II", data, pos + 8)
            if hi:
                raise J2kError("Cannot handle box sizes higher than 2^32")
            hlen = 16
        if tbox == b"jp2c":
            if not state & 4:
                raise J2kError("bad placed jpeg codestream")
            if ihdr is None:
                raise J2kError("IHDR box missing")
            return colour, ihdr, pos + hlen
        if lbox < hlen:
            raise J2kError("invalid box size")
        body = data[pos + hlen:pos + lbox]
        if tbox in (b"jP  ", b"ftyp", b"jp2h"):
            if len(body) != lbox - hlen:
                raise J2kError("Invalid box size")
            if tbox == b"jP  ":
                if state or len(body) != 4 or body != b"\r\n\x87\n":
                    raise J2kError("bad JPEG 2000 signature box")
                state = 1
            elif tbox == b"ftyp":
                if state != 1 or len(body) < 8 or (len(body) - 8) % 4:
                    raise J2kError("bad ftyp box")
                state |= 2
            else:
                if state & 3 != 3:
                    raise J2kError("The jp2h box must follow ftyp")
                ihdr, colour, has_colr = _opj_jp2h(body, ihdr, colour, has_colr)
                state |= 4
        elif tbox in (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef"):
            if state & 4:
                ihdr, colour, has_colr = _opj_jp2h(
                    data[pos:pos + lbox], ihdr, colour, has_colr)
        else:
            if not state & 1:
                raise J2kError("first box must be JPEG 2000 signature box")
            if not state & 2:
                raise J2kError("second box must be file type box")
            if pos + lbox > len(data):
                raise J2kError("Problem with skipping JPEG2000 box")
        pos += lbox


def _opj_jp2h(body: bytes, ihdr, colour, has_colr):
    pos = 0
    seen_ihdr = False
    pclr = None
    cmap = cdef = False
    while pos < len(body):
        if len(body) - pos < 8:
            raise J2kError("Cannot handle box of less than 8 bytes")
        lbox, tbox = struct.unpack_from(">I4s", body, pos)
        hlen = 8
        if lbox == 1:
            if len(body) - pos < 16:
                raise J2kError("Cannot handle XL box of less than 16 bytes")
            hi, lbox = struct.unpack_from(">II", body, pos + 8)
            if hi:
                raise J2kError("Cannot handle box sizes higher than 2^32")
            hlen = 16
        if lbox == 0 or lbox < hlen:
            raise J2kError("Box length is inconsistent")
        if lbox > len(body) - pos:
            raise J2kError("box length is inconsistent")
        b = body[pos + hlen:pos + lbox]
        if tbox == b"ihdr":
            seen_ihdr = True
            if ihdr is None:
                if len(b) != 14:
                    raise J2kError("Bad image header box (bad size)")
                h, w, nc = struct.unpack_from(">IIH", b)
                if h < 1 or w < 1 or nc < 1 or nc > 16384:
                    raise J2kError("Wrong values in ihdr")
                ihdr = (w, h, nc)
        elif tbox == b"colr":
            if len(b) < 3:
                raise J2kError("Bad COLR header box (bad size)")
            if not has_colr:
                if b[0] == 1:
                    if len(b) < 7:
                        raise J2kError("Bad COLR header box (bad size)")
                    (enumcs,) = struct.unpack_from(">I", b, 3)
                    colour = _ENUMCS.get(enumcs, UNKNOWN)
                    has_colr = True
                elif b[0] == 2:
                    colour = UNKNOWN
                    has_colr = True
        elif tbox == b"bpcc":
            if ihdr is None or len(b) != ihdr[2]:
                raise J2kError("Bad BPCC header box (bad size)")
        elif tbox == b"pclr":
            if pclr is not None or len(b) < 3:
                raise J2kError("bad PCLR box")
            ne, npc = struct.unpack_from(">HB", b)
            if ne == 0 or ne > 1024 or npc == 0 or len(b) < 3 + npc:
                raise J2kError("Invalid PCLR box")
            sizes = [min(((d & 0x7F) + 1 + 7) >> 3, 4) for d in b[3:3 + npc]]
            if len(b) < 3 + npc + ne * sum(sizes):
                raise J2kError("Invalid PCLR box")
            pclr = npc
        elif tbox == b"cmap":
            if pclr is None:
                raise J2kError("Need to read a PCLR box before the CMAP box")
            if cmap:
                raise J2kError("Only one CMAP box is allowed")
            if len(b) < 4 * pclr:
                raise J2kError("Insufficient data for CMAP box")
            cmap = True
        elif tbox == b"cdef":
            if cdef or len(b) < 2:
                raise J2kError("Insufficient data for CDEF box")
            (n,) = struct.unpack_from(">H", b)
            if n == 0 or len(b) < 2 + 6 * n:
                raise J2kError("Insufficient data for CDEF box")
            cdef = True
        pos += lbox
    if not seen_ihdr:
        raise J2kError("no 'ihdr' box")
    return ihdr, colour, has_colr


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + kind + body


def encode_jp2(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) uint8 -> a JP2 file, as PIL writes it."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else img.shape[2]
    header = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    header += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17 if nc == 1
                                        else 16))
    if nc == 4:
        header += _box(b"cdef", struct.pack(">H", 4) + b"".join(
            struct.pack(">HHH", c, 1 if c == 3 else 0, 0 if c == 3 else c + 1)
            for c in range(4)))
    return (JP2_MAGIC + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", header) + _box(b"jp2c", encode_j2k(img)))


def read_jpeg2000(data: bytes, where: str = "<jpeg2000>") -> np.ndarray:
    """A J2K codestream or JP2 / JPX file -> (H, W, 4) u8, as PIL's
    ``Image.open(...).convert("RGBA")`` gives it."""
    palette = None
    if data.startswith(J2K_MAGIC):
        if len(data) < 6:
            raise modes.NotThisFormat("JPEG 2000 codestream truncated")
        (lsiz,) = struct.unpack_from(">H", data, 4)
        siz = data[4:4 + lsiz]
        if len(siz) < 38:
            raise modes.NotThisFormat("SIZ truncated")
        xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", siz, 4)
        (csiz,) = struct.unpack_from(">H", siz, 36)
        size = (xsiz - xo, ysiz - yo)
        if csiz == 1:
            if len(siz) < 39:
                raise modes.NotThisFormat("SIZ truncated")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
        else:
            raise modes.NotThisFormat("unable to determine J2K image mode")
        colour, ihdr, start = UNSPECIFIED, None, 0
    elif data.startswith(JP2_MAGIC):
        size, mode, palette = _pil_jp2_header(data)
        colour, ihdr, start = _opj_jp2(data)
        ihdr = ihdr[:2]
    else:
        raise modes.NotThisFormat("not a JPEG 2000 file")
    modes.check_size(*size)
    try:
        return _decode(data[start:], ihdr, colour, size, mode, palette)
    except J2kError as e:
        raise ValueError(f"JPEG 2000 decode failed ({e}): {where}") from None


def _decode(stream: bytes, ihdr, colour, size, mode, palette) -> np.ndarray:
    w, h = size
    if w <= 0 or h <= 0:
        raise J2kError("image size is not positive")
    cs = Codestream(stream, ihdr)
    ncomp = len(cs.comps)
    if ncomp < 1 or ncomp > 4:
        raise J2kError("image is not one PIL decodes")
    first_sub = next((i for i, c in enumerate(cs.comps)
                      if c[2] != 1 or c[3] != 1), ncomp)
    if colour in (UNSPECIFIED, UNKNOWN):
        colour = GRAY if ncomp <= 2 else SRGB
        if ncomp >= 3 and first_sub == 1:
            colour = SYCC
    subsampled = first_sub < ncomp
    kind = _UNPACKERS.get((mode, colour, ncomp))
    if kind is None or (subsampled and not kind[1]):
        raise J2kError(f"no unpacker for {mode} from {ncomp} components")
    kind = kind[0]
    wide = mode == "I;16"
    img = np.zeros((h, w, 1 if mode in ("L", "P", "I;16") else 4),
                   np.uint16 if wide else np.uint8)
    ppm_state = [cs.ppm, 0] if cs.ppm is not None else None
    for tileno, tcp, tdata in cs.tiles():
        (tx0, ty0, tx1, ty1), planes = decode_tile(cs, tileno, tcp, tdata,
                                                   ppm_state)
        x0, y0 = tx0 - cs.x0, ty0 - cs.y0
        if (tx0 >= tx1 or ty0 >= ty1 or tx1 - cs.x0 > w or ty1 - cs.y0 > h):
            raise J2kError("tile outside the image")
        _unpack(kind, cs, planes, img, x0, y0, tx1 - tx0, ty1 - ty0)
    if mode in ("L", "I;16"):
        return modes.to_rgba(mode, img[..., 0])
    if mode == "P":
        return modes.to_rgba("P", img[..., 0], _palette_rows(palette))
    if mode == "PA":
        return modes.to_rgba("PA", img[..., [0, 3]], _palette_rows(palette))
    if mode == "LA":
        return modes.to_rgba("LA", img[..., [0, 3]])
    if mode == "CMYK":
        return modes.to_rgba("CMYK", img)
    if mode == "RGB":
        return modes.to_rgba("RGB", img[..., :3])
    return img


def _palette_rows(palette):
    raw, pmode = palette
    n = 4 if pmode == "RGBA" else 3
    return np.frombuffer(raw[:len(raw) // n * n], np.uint8).reshape(-1, n)


def _tile_buffer(planes, cs):
    """The bytes opj_decode_tile_data hands PIL: each component's samples
    in turn, 1, 2 or 4 bytes each by precision, little-endian."""
    chunks = []
    for p, (prec, _sgnd, _dx, _dy) in zip(planes, cs.comps):
        dt = {1: np.uint8, 2: "<u2", 4: "<u4"}[_csiz(prec)]
        chunks.append(p.astype(np.int64).astype(dt).ravel().view(np.uint8))
    return np.concatenate(chunks)


def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _read(buf, off: int, csiz: int, idx) -> np.ndarray:
    """Little-endian words of ``csiz`` bytes at ``off + idx * csiz`` (0
    past the end of the buffer)."""
    idx = np.asarray(idx, np.int64)
    out = np.zeros(idx.shape, np.int64)
    for k in range(csiz):
        at = off + idx * csiz + k
        ok = at < buf.size
        out |= np.where(ok, buf[np.where(ok, at, 0)], 0).astype(np.int64) << (8 * k)
    return out


def _shifted(words, prec: int, sgnd: int, bits: int = 8):
    """j2ku_shift(offset + word, bits - prec) in unsigned 32-bit."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        return ((offset + words) & 0xFFFFFFFF) >> -shift
    return (((offset + words) & 0xFFFFFFFF) << shift) & 0xFFFFFFFF


def _unpack(kind, cs, planes, img, x0, y0, tw, th):
    """Jpeg2KDecode.c's unpackers for one tile at (x0, y0) of the image."""
    buf = _tile_buffer(planes, cs)
    ys = np.arange(th)[:, None]
    xs = np.arange(tw)[None, :]
    region = img[y0:y0 + th, x0:x0 + tw]
    c0 = cs.comps[0]
    if kind in ("l", "i16", "grey_rgb"):
        v = _read(buf, 0, _csiz(c0[0]), ys * tw + xs)
        if kind == "i16":
            region[..., 0] = _shifted(v, c0[0], c0[1], 16) & 0xFFFF
        elif kind == "l":
            region[..., 0] = _shifted(v, c0[0], c0[1]) & 0xFF
        else:
            grey = _shifted(v, c0[0], c0[1]) & 0xFF
            region[..., 0] = region[..., 1] = region[..., 2] = grey
            region[..., 3] = 255
        return
    if kind == "la":
        c1 = cs.comps[1]
        v = _read(buf, 0, _csiz(c0[0]), ys * tw + xs)
        a = _read(buf, _csiz(c0[0]) * tw * th, _csiz(c1[0]), ys * tw + xs)
        grey = _shifted(v, c0[0], c0[1]) & 0xFF
        region[..., 0] = region[..., 1] = region[..., 2] = grey
        region[..., 3] = _shifted(a, c1[0], c1[1]) & 0xFF
        return
    n = 4 if kind in ("rgba", "ycca") else 3
    off = 0
    for c, (prec, sgnd, dx, dy) in enumerate(cs.comps):
        stride = tw // dx
        if c < n:
            v = _read(buf, off, _csiz(prec), (ys // dy) * stride + xs // dx)
            region[..., c] = _shifted(v, prec, sgnd) & 0xFF
        off += _csiz(prec) * stride * (th // dy)
    if n == 3:
        region[..., 3] = 255
    if kind in ("ycc", "ycca"):
        region[..., :3] = modes.ycbcr_to_rgb(region[..., :3])
