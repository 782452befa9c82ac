"""TIFF reading and writing without PIL: the first page, as Pillow 12.1's
TiffImagePlugin.py opens it (``TiffImageFile._setup`` and its OPEN_INFO
table) and decodes it (its raw decoder for uncompressed data; libtiff
4.7's TIFFReadEncodedStrip / TIFFReadEncodedTile, tif_lzw.c, tif_zip.c,
tif_lzma.c, tif_zstd.c, tif_fax3.c, tif_packbits.c, tif_predict.c,
tif_jpeg.c and tif_ojpeg.c for the rest, and its RGBA interface,
tif_getimage.c, for compressed YCbCr), converted as
``Image.convert("RGBA")`` converts it, then transposed by the Orientation
tag as PIL's ``load_end`` does (``ImageOps.exif_transpose``).

Covered: classic TIFF and BigTIFF; byte orders II and MM; strips and
tiles; compression 1 (none), 2, 3 and 4 (CCITT MH, T.4 1-D / 2-D and
T.6, assets/ccitt.py), 5 (LZW, new and old style, assets/lzw.py), 6
(old-style JPEG, its JPEGInterchangeFormat and table forms, decoded raw
by assets/jpeg.py), 7 (JPEG, each strip or tile an abbreviated stream
after the JPEGTables tables, decoded by assets/jpeg.py; in planar files
one component per plane; 12-bit grey as tif_jpeg.c packs it), 8 and
32946 (Deflate, through zlib), 32773 (PackBits), 34925 (LZMA, through
the standard library's lzma) and 50000 (ZSTD, assets/zstd.py);
predictor 1, 2 (horizontal differencing on 8-, 16- and 32-bit samples)
and 3 (floating point; like PIL, uncompressed data ignores the
predictor, and so do PackBits, CCITT and JPEG); FillOrder 2 where PIL's
table has it; planar configuration 1 and 2 (compressed LA and PA planes
come out with alpha 0, as PIL's libtiff decoder leaves them); photometric
0 (WhiteIsZero) and 1 (BlackIsZero) at 1, 2, 4, 8, 16 and 32 bits, 12
bits (little-endian BlackIsZero only, PIL's I;12) and as 32-bit floats
(mode F: truncated and clipped to 0-255); 2 (RGB) at 8 and 16 bits with
ExtraSamples 0 (ignored), 1 (associated alpha, PIL's RGBa: rgb * 255 // a
at unpack time, black where a is 0) and 2 (unassociated alpha); 3
(palette) at 1, 2, 4 and 8 bits with a 16-bit ColorMap (its high bytes),
with or without an alpha sample; 5 (CMYK) at 8 bits (with one or two
ignored extra samples) and 16 bits; 6 (YCbCr): JPEG-compressed through
libjpeg's conversion and upsampling, otherwise libtiff's (single-precision
coefficient and reference black / white tables, 16-bit fixed point, each
data unit's chroma on all its pixels) for the subsamplings libtiff
converts, planes at 1 x 1 only.

PIL's and libtiff's quirks are kept: 16-bit grey is I;16 (clipped at 255,
WhiteIsZero not inverted), 16-bit colour keeps each sample's high byte,
an RGB image with a fourth sample and no ExtraSamples is RGBA, 8-bit
samples marked signed read as unsigned; compressed floats of a
big-endian file are byte-swapped (PIL unpacks libtiff's native floats
with the file's raw mode); uncompressed 3-sample YCbCr is read as PIL's
raw decoder reads it, 4 bytes a pixel as RGBX, unconverted, and
uncompressed planar YCbCr as its three planes, unconverted; a 1-sample
YCbCr file reads as grey when uncompressed and is refused otherwise; a
YCbCr strip gives the RGBA interface only rows x (sampling row size //
vs) bytes, and its 4 x 4 tile routine skips 10 bytes, not 18, for each
unit past a tile's visible width; old-style JPEG reads 3 samples as YCbCr
whatever the photometric tag says and grey uninverted; an LZMA strip
whose buffer is full succeeds whatever liblzma reports after it; a ZSTD
strip is the first frame only. What PIL refuses raises ValueError naming
it: WebP (50001) and JPEG 2000 (34712), for which PIL's libtiff has no
codec, and other codecs; planar YCbCr other than 1 x 1; other 12-bit
layouts and 12-bit predictors; photometric 4, 7 and 9 up (ICCLab,
ITULab, and the rest). Photometric 8 (CIELab) at 8 bits is read as PIL
reads it: contiguous samples with signed a and b, planes as stored,
converted by modes.lab_to_rgb with alpha 255 (contiguous) or 0 (planar,
PIL's fourth byte left unset).

Write: L, RGB and RGBA (ExtraSamples 2), uncompressed, little-endian, one
strip, which PIL reads back as the same mode and pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import ccitt, jpeg, lzw, modes, zstd

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3 fax",
                 4: "CCITT Group 4 fax", 5: "LZW", 6: "old-style JPEG",
                 7: "JPEG", 8: "Deflate", 32773: "PackBits",
                 32946: "Deflate", 34676: "SGI LogLuv", 34712: "JPEG 2000",
                 34887: "LERC", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
                 32809: "ThunderScan", 32908: "Pixar film",
                 32909: "Pixar log"}
_PHOTOMETRIC = {4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr",
                8: "CIELab", 9: "ICCLab", 10: "ITULab", 32844: "LogL",
                32845: "LogLuv", 32803: "CFA", 34892: "LinearRaw"}
(WIDTH, LENGTH, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIPOFFSETS,
 ORIENTATION, SPP, ROWSPERSTRIP, STRIPBYTECOUNTS, PLANAR, PREDICTOR,
 COLORMAP, TILEWIDTH, TILELENGTH, TILEOFFSETS, TILEBYTECOUNTS,
 EXTRASAMPLES, SAMPLEFORMAT, JPEGTABLES, YCBCRCOEFFICIENTS,
 YCBCRSUBSAMPLING, REFERENCEBLACKWHITE, T4OPTIONS) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320,
    322, 323, 324, 325, 338, 339, 347, 529, 530, 532, 292)
# the codecs the port decodes; PIL's libtiff has no WebP (50001) or JPEG
# 2000 (34712) codec, and PIL refuses those files too
_READ = (1, 2, 3, 4, 5, 6, 7, 8, 32773, 32946, 34925, 50000)


def looks_like_tiff(head: bytes) -> bool:
    """PIL's prefixes: II or MM with 42 (or the two byte-swapped forms),
    and BigTIFF's 43."""
    return head[:4] in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                        b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")


def _first_ifd(buf: bytes, where: str) -> tuple[str, dict]:
    """The byte order and the first IFD's tags; BigTIFF (version 43: 8-byte
    offsets and counts, 20-byte entries) as classic TIFF."""
    bo = "<" if buf[:2] == b"II" else ">"
    if buf[2:4] in (b"\x2b\x00", b"\x00\x2b"):
        size, _, off = struct.unpack_from(bo + "HHQ", buf, 4)
        if size != 8:
            raise ValueError(f"BigTIFF offset size {size} is not 8: {where}")
        num, entry, inline, ref = "Q", 20, 8, "Q"
    else:
        (off,) = struct.unpack_from(bo + "I", buf, 4)
        num, entry, inline, ref = "H", 12, 4, "I"
    head = struct.calcsize(num)
    if off + head > len(buf):
        raise ValueError(f"TIFF IFD offset past the file: {where}")
    (n,) = struct.unpack_from(bo + num, buf, off)
    tags = {}
    for i in range(n):
        e = off + head + entry * i
        if e + entry > len(buf):
            raise ValueError(f"TIFF IFD truncated: {where}")
        tag, typ = struct.unpack_from(bo + "HH", buf, e)
        (count,) = struct.unpack_from(bo + ref, buf, e + 4)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize("<" + fmt) * count
        at = e + 4 + struct.calcsize(ref)
        pos = at if size <= inline else struct.unpack_from(bo + ref, buf,
                                                           at)[0]
        if pos + size > len(buf):
            raise ValueError(f"TIFF tag {tag} data past the file: {where}")
        if typ == 2:
            tags[tag] = buf[pos:pos + count]
            continue
        vals = struct.unpack_from(bo + fmt * count, buf, pos)
        if typ in (5, 10):
            vals = tuple(a / b if b else 0 for a, b in zip(vals[::2],
                                                           vals[1::2]))
        tags[tag] = vals
    return bo, tags


def _scalar(tags, tag, default):
    v = tags.get(tag)
    return default if not v else v[0]


def _mode(bo, photo, fmt, fill, bps, extra, where):
    """PIL's OPEN_INFO: (mode, how the samples become the mode's pixels)
    or ValueError."""
    b8 = all(b == 8 for b in bps)
    n = len(bps)
    if photo not in (0, 1, 2, 3, 5, 6, 8):
        name = _PHOTOMETRIC.get(photo, str(photo))
        raise ValueError(f"TIFF photometric {photo} ({name}) is not read by "
                         f"the port: {where}")
    if photo in (0, 1) and n == 1 and not extra:
        b = bps[0]
        if b == 32 and fmt == (3,) and fill == 1:
            return "F", ""
        if b in (1, 2, 4) and fmt == (1,):
            return ("1" if b == 1 else "L"), ("invert" if photo == 0 else "")
        if b == 8 and (fmt == (1,) or (fmt == (2,) and photo == 1)):
            if fill == 2 and fmt == (2,):
                raise ValueError(f"TIFF unknown pixel mode: {where}")
            return "L", "invert" if photo == 0 else ""
        if b == 12 and fmt == (1,) and bo == "<" and photo == 1 \
                and fill == 1:
            return "I;16", ""  # PIL's raw mode I;12
        if b == 16 and fill == 1:
            if fmt == (1,) and (bo == "<" or photo == 1):
                return "I;16", ""
            if fmt == (2,) and photo == 1:
                return "I", ""
        if b == 16 and fill == 2 and fmt == (1,) and bo == "<" and photo:
            return "I;16", ""
        if b == 32 and photo == 1 and fill == 1 and (
                fmt == (2,) or (fmt == (1,) and bo == "<")):
            return "I", ""
    if fill == 2 and not (photo in (0, 1, 3) and n == 1 and bps[0] <= 8
                          and not extra) and not (
            photo == 2 and bps == (8, 8, 8) and not extra):
        raise ValueError(f"TIFF FillOrder 2 with these samples is not read "
                         f"(PIL: unknown pixel mode): {where}")
    if fmt != (1,):
        raise ValueError(f"TIFF SampleFormat {fmt} at {bps} bits is not "
                         f"read (PIL: unknown pixel mode): {where}")
    if photo == 1 and bps == (8, 8) and extra == (2,):
        return "LA", ""
    if photo == 8 and bps == (8, 8, 8) and not extra:
        return "LAB", ""
    if photo == 5 and (bps, extra) in (((8,) * 4, ()), ((8,) * 5, (0,)),
                                       ((8,) * 6, (0, 0)), ((16,) * 4, ())):
        return "CMYK", ""
    if photo == 6 and bps == (8,) and not extra:
        return "L", ""
    if photo == 6 and bps == (8, 8, 8) and not extra:
        return "RGB", "ycbcr"
    if photo == 2 and (b8 or all(b == 16 for b in bps)):
        if n == 3 and not extra:
            return "RGB", ""
        if n == 4 and not extra:
            return "RGBA", ""
        if b8 and extra == (999,) and n == 4:
            return "RGBA", ""
        if len(extra) == n - 3 and all(x == 0 for x in extra[1:]) and (
                b8 or n == 4):
            kind = {0: ("RGB", ""), 1: ("RGBA", "premultiplied"),
                    2: ("RGBA", "")}.get(extra[0])
            if kind:
                return kind
    if photo == 3 and n == 1 and bps[0] in (1, 2, 4, 8) and not extra:
        return "P", ""
    if photo == 3 and bps == (8, 8) and extra in ((0,), (2,)):
        return ("P", "") if extra == (0,) else ("PA", "")
    raise ValueError(f"TIFF photometric {photo}, {bps} bits, ExtraSamples "
                     f"{extra} is not a pixel layout PIL reads: {where}")


def _packbits(data: bytes, limit: int) -> bytes:
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n and len(out) < limit:
        c = data[pos]
        pos += 1
        if c < 128:
            out += data[pos:pos + c + 1]
            pos += c + 1
        elif c > 128:
            out += data[pos:pos + 1] * (257 - c)
            pos += 1
    return bytes(out)


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)


def _samples(raw: bytes, rows: int, width: int, spp: int, bits: int,
             bo: str, where: str) -> np.ndarray:
    """A chunk's rows (each byte-aligned) -> (rows, width, spp) samples."""
    stride = (width * spp * bits + 7) // 8
    if len(raw) < stride * rows:
        raise ValueError(f"TIFF strip or tile data too short: {where}")
    b = np.frombuffer(raw, np.uint8, stride * rows).reshape(rows, stride)
    if bits in (8, 16, 32):
        dt = {8: np.uint8, 16: np.dtype(bo + "u2"), 32: np.dtype(bo + "u4")}
        return b.copy().view(dt[bits])[:, :width * spp].reshape(
            rows, width, spp)
    # packed most significant bit first (12-bit samples as PIL's I;12)
    bit = np.unpackbits(b, axis=1)[:, :width * spp * bits]
    w = 1 << np.arange(bits - 1, -1, -1)
    return (bit.reshape(rows, width * spp, bits) * w).sum(-1).astype(
        np.uint8 if bits < 8 else np.uint16).reshape(rows, width, spp)


def read_tiff(buf: bytes, where: str = "<tiff>") -> np.ndarray:
    """TIFF bytes -> (H, W, 4) u8 of the first page, as PIL's
    Image.open(...).convert("RGBA") gives them."""
    if not looks_like_tiff(buf):
        raise ValueError(f"not a TIFF file: {where}")
    bo, tags = _first_ifd(buf, where)
    if 0xBC01 in tags:
        raise ValueError(f"Windows Media Photo in TIFF is not read: {where}")
    comp = _scalar(tags, COMPRESSION, 1)
    if comp not in _READ:
        name = _COMPRESSIONS.get(comp, str(comp))
        why = " (PIL's libtiff has no codec for it either)" if comp in (
            34712, 50001) else ""
        raise ValueError(f"TIFF compression {comp} ({name}) is not read by "
                         f"the port{why}: {where}")
    planar = _scalar(tags, PLANAR, 1)
    photo = _scalar(tags, PHOTOMETRIC, 0)
    fill = _scalar(tags, FILLORDER, 1)
    if WIDTH not in tags or LENGTH not in tags:
        raise ValueError(f"TIFF without its dimensions: {where}")
    w, h = tags[WIDTH][0], tags[LENGTH][0]
    fmt = tuple(tags.get(SAMPLEFORMAT, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tuple(tags.get(BPS, (1,)))
    extra = tuple(tags.get(EXTRASAMPLES, ()))
    spp = _scalar(tags, SPP, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp or spp > 6:
        raise ValueError(f"TIFF unknown data organization ({spp} samples, "
                         f"BitsPerSample {bps}): {where}")
    mode, how = _mode(bo, photo, fmt, fill, bps, extra, where)
    modes.check_size(w, h)
    bits = bps[0]
    if len(set(bps)) != 1:
        raise ValueError(f"TIFF samples of mixed sizes {bps}: {where}")
    predictor = _scalar(tags, PREDICTOR, 1)
    if comp in (5, 8, 32946, 34925, 50000) and predictor != 1:
        if predictor not in (2, 3):
            raise ValueError(f"TIFF predictor {predictor} is not read by the "
                             f"port: {where}")
        if predictor == 2 and bits not in (8, 16, 32):
            raise ValueError(f"TIFF horizontal predictor at {bits} bits "
                             f"(libtiff refuses it): {where}")
        if predictor == 3 and mode != "F":
            raise ValueError(f"TIFF floating-point predictor on integer "
                             f"samples (libtiff refuses it): {where}")
    else:
        predictor = 1
    sub = tuple(tags.get(YCBCRSUBSAMPLING, (2, 2)))[:2]
    if photo == 6 and spp == 1 and comp != 1:
        raise ValueError(f"compressed YCbCr TIFF with 1 sample (libtiff: "
                         f"invalid samples per pixel): {where}")
    if photo == 6 and spp == 3 and planar == 2:
        if comp == 1:
            how = ""  # PIL's raw decoder: the planes as R, G, B, unconverted
        elif sub != (1, 1):
            # tif_getimage.c has a separate-plane YCbCr routine for 1 x 1 only
            raise ValueError(f"planar YCbCr TIFF with subsampling {sub} "
                             f"(libtiff: can not handle it): {where}")
    elif photo == 6 and spp == 3:
        if comp not in (1, 7) and sub not in _YCBCR_BLOCKS:
            raise ValueError(f"TIFF YCbCr subsampling {sub} (libtiff: can "
                             f"not handle it): {where}")
        if comp not in (1, 7) and sub != (1, 1) and predictor != 1:
            raise ValueError(f"TIFF predictor on subsampled YCbCr is not "
                             f"read by the port: {where}")
    if comp == 7 and bits not in (8, 12):
        raise ValueError(f"TIFF JPEG compression at {bits} bits (libtiff: "
                         f"improper JPEG data precision): {where}")
    if comp in (2, 3, 4) and (bits != 1 or spp != 1):
        raise ValueError(f"TIFF CCITT compression with {spp} samples of "
                         f"{bits} bits (libtiff: bits/sample must be 1): "
                         f"{where}")
    if planar == 2 and comp != 1 and mode == "RGB" and spp > 3:
        raise ValueError(f"planar TIFF with an ignored extra sample (PIL: "
                         f"decoder error): {where}")
    if mode == "LAB" and planar == 2:
        how = "planar"
    if planar == 2 and comp == 1 and not (bits == 8 and how in ("", "planar")
                                          and mode in ("RGB", "RGBA", "LAB")):
        # PIL's raw decoder reads each plane with one letter of the mode's
        # raw mode, which exists only for 8-bit R, G, B and A
        raise ValueError(f"uncompressed planar TIFF in mode {mode} at "
                         f"{bits} bits (PIL: unknown raw mode): {where}")
    tiled = TILEOFFSETS in tags
    if tiled:
        offsets, counts = tags[TILEOFFSETS], tags.get(TILEBYTECOUNTS, ())
        cw, ch = _scalar(tags, TILEWIDTH, 0), _scalar(tags, TILELENGTH, 0)
        if not cw or not ch:
            raise ValueError(f"TIFF tile size missing: {where}")
    elif STRIPOFFSETS in tags:
        offsets, counts = tags[STRIPOFFSETS], tags.get(STRIPBYTECOUNTS, ())
        cw, ch = w, min(_scalar(tags, ROWSPERSTRIP, h), h)
    else:
        raise ValueError(f"TIFF without strips or tiles: {where}")
    if how == "ycbcr" and comp == 1:
        rgb = _raw_rgbx(buf, offsets, w, h, cw, ch, where)
        return _orient(modes.to_rgba("RGB", rgb), tags)
    if comp == 6:
        if tiled or planar == 2 or bits != 8 or spp not in (1, 3):
            raise ValueError(f"old-style JPEG TIFF with {spp} samples of "
                             f"{bits} bits, planar configuration {planar}, "
                             f"{'tiles' if tiled else 'strips'} is not read "
                             f"by the port: {where}")
        s = _ojpeg(buf, tags, offsets, counts, w, h, ch, spp, where)
        # converted from YCbCr whatever PhotometricInterpretation says (RGB
        # too, as libtiff reads it); grey stays as decoded, WhiteIsZero
        # too (PIL does not invert it)
        return _orient(_convert(mode, "", s, 8, tags, where), tags)
    planes = spp if planar == 2 else 1
    per_chunk = spp // planes
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) < across * down * planes:
        raise ValueError(f"TIFF has {len(offsets)} strips or tiles, the "
                         f"image needs {across * down * planes}: {where}")
    subsampled = how == "ycbcr" and comp != 7 and planar == 1
    if comp == 7:
        tables = bytes(tags.get(JPEGTABLES, b""))
        if photo == 6 and planar == 1:
            how = ""  # libjpeg converts to RGB
    fax = _scalar(tags, T4OPTIONS, 0) if comp == 3 else 0
    fax_mode = {}  # libtiff's codec mode, kept from strip to strip
    dt = np.uint8 if bits <= 8 else np.uint32 if bits == 32 else np.uint16
    out = np.zeros((h, w, spp), dt)
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                k = (p * down + ty) * across + tx
                rows = ch if tiled else min(ch, h - ty * ch)
                if subsampled:
                    hs, vs = sub
                    stride = -(-cw // hs) * (hs * vs + 2)
                    need = stride * -(-rows // vs)
                else:
                    stride = (cw * per_chunk * bits + 7) // 8
                    need = stride * rows
                start = offsets[k]
                if comp == 1:
                    raw = buf[start:start + need]
                else:
                    size = counts[k] if k < len(counts) else len(buf) - start
                    raw = buf[start:start + size]
                if fill == 2:
                    raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                if comp == 7:
                    s = _jpeg_chunk(raw, tables, photo, per_chunk, sub, rows,
                                    cw, bits, bo, planar, where)
                elif comp in (2, 3, 4):
                    s = _samples(ccitt.decode(raw, comp, fax, cw, rows, where,
                                              fax_mode),
                                 rows, cw, 1, 1, bo, where)
                else:
                    raw = _decompress(raw, comp, need, where)
                    if predictor == 3:
                        raw = _fp_accumulate(raw, rows, stride, per_chunk,
                                             where)
                    if subsampled:
                        if not tiled:
                            # libtiff's RGBA interface reads rows x
                            # (sampling row size // vs) bytes of a strip;
                            # the rest of its buffer stays 0
                            keep = -(-rows // vs) * vs * (stride // vs)
                            raw = raw[:keep].ljust(need, b"\0")
                        visible = min(cw, w - tx * cw) if tiled else cw
                        s = _ycbcr_units(raw, rows, cw, sub, where, visible)
                    else:
                        s = _samples(raw, rows, cw, per_chunk, bits,
                                     ">" if predictor == 3 else bo, where)
                if predictor == 2:
                    s = np.cumsum(s.astype(np.uint64), axis=1).astype(s.dtype)
                y0, x0 = ty * ch, tx * cw
                y1, x1 = min(y0 + rows, h), min(x0 + cw, w)
                out[y0:y1, x0:x1, p:p + per_chunk] = s[:y1 - y0, :x1 - x0]
    if planar == 2 and mode in ("LA", "PA"):
        # PIL's libtiff decoder puts each plane in the band of its index;
        # these modes keep alpha in band 3, which stays 0
        out[..., 1] = 0
    if mode == "F" and bo == ">" and comp != 1:
        # libtiff hands PIL native (little-endian) floats, which PIL
        # unpacks with the file's big-endian raw mode
        out = out.byteswap()
    if how == "ycbcr" and (subsampled or planar == 2):
        # libtiff's RGBA interface: subsampled units, or separate planes
        out = ycbcr_to_rgb(out, tags)
        how = ""
    return _orient(_convert(mode, how, out, bits, tags, where), tags)


def _ojpeg(buf: bytes, tags, offsets, counts, w: int, h: int, rows: int,
           spp: int, where: str) -> np.ndarray:
    """Old-style JPEG (compression 6) as libtiff's tif_ojpeg.c reads it:
    one JPEG stream for the whole image, its header from the
    JPEGInterchangeFormat stream (513, cut at the first strip when that
    lies inside it; its bytes after SOS are scan data too) or built from
    the JPEGQTables, JPEGDCTables and JPEGACTables (519-521, component k
    on table k, component 0 sampled as YCbCrSubsampling says), its scan
    the strips joined by RST markers (the restart interval from the
    header's DRI, JPEGRestartInterval (515), or one strip's MCUs). Only
    sequential Huffman frames are read (libtiff refuses other SOF markers
    in the header); JPEGProc (512) is not consulted, as libtiff does not.
    3 samples are YCbCr whatever PhotometricInterpretation says, decoded
    raw (not upsampled) and converted by libtiff's RGBA interface, each
    sampling unit's chroma on all its pixels; the sampling is the
    stream's (libtiff corrects the tag from the SOF). -> (H, W, spp)
    samples as PIL's unpacker takes them."""
    strips = []
    for k, off in enumerate(offsets):
        size = counts[k] if k < len(counts) else len(buf) - off
        strips.append(buf[off:off + size])
    jif = _scalar(tags, 513, 0)
    if jif:
        if jif >= len(buf):
            raise ValueError(f"old-style JPEG stream past the file: {where}")
        length = _scalar(tags, 514, 0) or len(buf) - jif
        if offsets and jif < offsets[0] < jif + length:
            length = offsets[0] - jif
        head, rest = _ojpeg_header(buf[jif:jif + length], where)
    else:
        head, rest = _ojpeg_tables(buf, tags, spp, w, h, where), b""
    sof, dri = _sof_and_dri(head, where)
    restart = dri or _scalar(tags, 515, 0)
    if not restart and len(strips) > 1:
        hmax = max(b >> 4 for b in sof[7::3])
        vmax = max(b & 15 for b in sof[7::3])
        mcux = -(-(sof[3] << 8 | sof[4]) // (8 * hmax))
        restart = mcux * max(rows // (8 * vmax), 1)
    if restart and not dri:
        sof = head.index(b"\xff\xda")
        head = head[:sof] + b"\xff\xdd\x00\x04" + struct.pack(
            ">H", restart) + head[sof:]
    scan = bytearray(rest + (strips[0] if strips else b""))
    for k, strip in enumerate(strips[1:]):
        scan += bytes([0xFF, 0xD0 + k % 8]) + strip
    try:
        fr, planes = jpeg.decode_raw(head + bytes(scan) + b"\xff\xd9", where)
    except ValueError as e:
        raise ValueError(f"old-style JPEG data: {e}") from None
    if len(planes) != spp or fr.width < w or fr.height < h:
        raise ValueError(f"old-style JPEG frame of {len(planes)} components "
                         f"at {fr.width}x{fr.height} for a {w}x{h} image of "
                         f"{spp} samples: {where}")
    if spp == 1:
        return planes[0][:h, :w, None]
    hs, vs = fr.comps[0].h, fr.comps[0].v
    if any((c.h, c.v) != (1, 1) for c in fr.comps[1:]) or (
            hs, vs) not in _YCBCR_BLOCKS:
        raise ValueError(f"old-style JPEG sampling "
                         f"{[(c.h, c.v) for c in fr.comps]} (libtiff: can "
                         f"not handle it): {where}")
    ycc = np.stack([planes[0][:h, :w]] + [
        np.repeat(np.repeat(p, vs, 0), hs, 1)[:h, :w] for p in planes[1:]],
        -1)
    return ycbcr_to_rgb(ycc, tags)


def _sof_and_dri(head: bytes, where: str):
    """The SOF body and the restart interval of a JPEG header."""
    i, sof, dri = 2, None, 0
    while i + 4 <= len(head):
        m, n = head[i + 1], head[i + 2] << 8 | head[i + 3]
        if m in (0xC0, 0xC1):
            sof = head[i + 4:i + 2 + n]
        elif m == 0xDD and n >= 4:
            dri = head[i + 4] << 8 | head[i + 5]
        i += 2 + n
    if sof is None or len(sof) < 6 + 3 * sof[5]:
        raise ValueError(f"old-style JPEG header without a frame: {where}")
    return sof, dri


def _ojpeg_header(region: bytes, where: str):
    """The JPEGInterchangeFormat stream's header up to its SOS segment, and
    the bytes after it; tif_ojpeg.c reads SOI, DQT, DHT, DRI, SOF0, SOF1,
    APPn, COM and SOS, and refuses every other marker."""
    if region[:2] != b"\xff\xd8":
        raise ValueError(f"old-style JPEG stream without SOI: {where}")
    i = 2
    while i + 4 <= len(region):
        if region[i] != 0xFF:
            raise ValueError(f"old-style JPEG header: bytes between "
                             f"markers: {where}")
        m = region[i + 1]
        if m == 0xFF:
            i += 1
            continue
        if m not in (0xC0, 0xC1, 0xC4, 0xDB, 0xDA, 0xDD, 0xFE) and not (
                0xE0 <= m <= 0xEF):
            raise ValueError(f"old-style JPEG header: marker 0x{m:02X} "
                             f"(libtiff: unknown marker type): {where}")
        end = i + 2 + (region[i + 2] << 8 | region[i + 3])
        if m == 0xDA:
            return region[:end], region[end:]
        i = end
    raise ValueError(f"old-style JPEG stream without SOS: {where}")


def _ojpeg_tables(buf: bytes, tags, spp: int, w: int, h: int,
                  where: str) -> bytes:
    """The header tif_ojpeg.c writes from JPEGQTables, JPEGDCTables and
    JPEGACTables: component k on tables k, YCbCrSubsampling on component
    0 of 3."""
    q, dc, ac = (tuple(tags.get(t, ())) for t in (519, 520, 521))
    if len(q) < spp or len(dc) < spp or len(ac) < spp:
        raise ValueError(f"old-style JPEG without its tables (libtiff: "
                         f"missing JPEG tables): {where}")
    out = bytearray(b"\xff\xd8")
    for k in range(spp):
        if q[k] + 64 > len(buf):
            raise ValueError(f"old-style JPEG table past the file: {where}")
        out += b"\xff\xdb\x00\x43" + bytes([k]) + buf[q[k]:q[k] + 64]
    for cls, offs in ((0x00, dc), (0x10, ac)):
        for k in range(spp):
            counts = buf[offs[k]:offs[k] + 16]
            n = sum(counts)
            table = buf[offs[k]:offs[k] + 16 + n]
            if len(counts) < 16 or len(table) < 16 + n:
                raise ValueError(f"old-style JPEG table past the file: "
                                 f"{where}")
            out += b"\xff\xc4" + struct.pack(">H", 3 + len(table)) + bytes(
                [cls | k]) + table
    sub = tuple(tags.get(YCBCRSUBSAMPLING, (2, 2)))[:2] if spp == 3 \
        else (1, 1)
    sof = struct.pack(">BHHB", 8, h, w, spp) + b"".join(
        bytes([k + 1, (sub if k == 0 else (1, 1))[0] << 4
               | (sub if k == 0 else (1, 1))[1], k]) for k in range(spp))
    out += b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
    sos = bytes([spp]) + b"".join(bytes([k + 1, k << 4 | k])
                                  for k in range(spp)) + bytes([0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    return bytes(out)


def _decompress(raw: bytes, comp: int, need: int, where: str) -> bytes:
    if comp == 5:
        return lzw.decode_tiff(raw, need)
    if comp == 34925:
        return _lzma(raw, need, where)
    if comp == 50000:
        return zstd.decode_strip(raw, need, where)
    if comp in (8, 32946):
        try:
            return zlib.decompressobj().decompress(raw, need)
        except zlib.error as e:
            raise ValueError(f"TIFF Deflate data does not inflate ({e}): "
                             f"{where}") from None
    if comp == 32773:
        return _packbits(raw, need)
    return raw


def _lzma(raw: bytes, need: int, where: str) -> bytes:
    """tif_lzma.c: liblzma's .xz stream decoder, one call with the whole
    strip's data and a buffer of `need` bytes; libtiff succeeds when the
    buffer is full, even where liblzma reports an error in that call (as
    it does when an LZMA2 chunk that ends at the buffer's end fails its
    final range-coder check, or the index or footer after it is bad).
    Python's lzma raises there and keeps no output, so that chunk is read
    again one byte longer out and 16 zero bytes longer in, which gives the
    same bytes and stops before any check."""
    import lzma  # the standard library's liblzma binding, on first use

    try:
        return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(raw, need)
    except lzma.LZMAError as e:
        err = e
    longer = _xz_chunk_ending_at(raw, need)
    if longer is not None:
        try:
            out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(longer,
                                                                   need)
            if len(out) == need:
                return out
        except lzma.LZMAError:
            pass
    raise ValueError(f"TIFF LZMA data does not decode ({err}): {where}")


def _xz_chunk_ending_at(raw: bytes, end: int):
    """The .xz stream with its first block's LZMA2 chunk that ends at
    uncompressed byte `end` made longer, or None."""
    if raw[:6] != b"\xfd7zXZ\0" or len(raw) < 14 or raw[13] & 0xC0:
        return None  # not .xz, or a block header that records sizes
    pos, out = 12 + (raw[12] + 1) * 4, 0
    while pos + 5 < len(raw):
        c = raw[pos]
        if c in (1, 2):  # an uncompressed chunk
            out += (raw[pos + 1] << 8 | raw[pos + 2]) + 1
            pos += 3 + (raw[pos + 1] << 8 | raw[pos + 2]) + 1
            continue
        if c < 0x80:
            return None
        size = ((c & 0x1F) << 16 | raw[pos + 1] << 8 | raw[pos + 2]) + 1
        packed = (raw[pos + 3] << 8 | raw[pos + 4]) + 1
        data_at = pos + (6 if c >= 0xC0 else 5)
        if out + size == end:
            if size >= 1 << 21 or packed + 16 > 1 << 16:
                return None
            # one more byte out of 16 more (zero) bytes in: the range
            # decoder reaches neither before the buffer is full (liblzma
            # 5.4 reads a few bytes further ahead on bad data than the
            # 5.8 that PIL links, which needs none of them)
            head = bytes([(c & 0xE0) | size >> 16, (size >> 8) & 255,
                          size & 255, (packed + 15) >> 8, (packed + 15) & 255])
            at = data_at + packed
            return raw[:pos] + head + raw[pos + 5:at] + bytes(16) + raw[at:]
        out += size
        pos = data_at + packed
    return None


def _fp_accumulate(raw: bytes, rows: int, stride: int, spp: int,
                   where: str) -> bytes:
    """tif_predict.c fpAcc on each row of 32-bit floats: undo the byte
    differences (spp bytes apart), then gather each sample's bytes from
    the row's four byte planes (most significant first) as big-endian."""
    if len(raw) < rows * stride:
        raise ValueError(f"TIFF strip or tile data too short: {where}")
    b = np.frombuffer(raw, np.uint8, rows * stride).reshape(rows, -1, spp)
    b = np.cumsum(b, axis=1, dtype=np.uint64).astype(np.uint8)
    planes = b.reshape(rows, 4, stride // 4)
    return np.ascontiguousarray(planes.transpose(0, 2, 1)).tobytes()


def _jpeg_chunk(raw: bytes, tables: bytes, photo: int, spp: int, sub,
                rows: int, cols: int, bits: int, bo: str, planar: int,
                where: str) -> np.ndarray:
    """One strip or tile of JPEG compression (7) through jpeg.py: the
    abbreviated stream after the JPEGTables stream's tables; contiguous
    YCbCr converted to RGB (libtiff's JPEGCOLORMODE_RGB), every other
    colour space (and each plane of a planar file) left as stored. libtiff's
    checks are kept: the component count is the samples per chunk,
    component 0 has the YCbCr subsampling (1 x 1 outside contiguous YCbCr)
    and the others 1 x 1, the data precision is the bits per sample, and
    the stream is the strip's or tile's size (the last strip's may be
    taller). 12-bit samples come out as tif_jpeg.c packs them, two to
    three bytes, a row's odd last sample left 0, and are unpacked as
    PIL's I;12 reads them."""
    if tables.endswith(b"\xff\xd9") and raw.startswith(b"\xff\xd8"):
        raw = tables[:-2] + raw[2:]
    contig_ycc = photo == 6 and planar == 1
    px, sampling = jpeg.decode_components(raw, where, ycbcr=contig_ycc,
                                          precision=bits)
    want = sub if contig_ycc else (1, 1)
    if len(sampling) != spp or sampling[0] != want or any(
            f != (1, 1) for f in sampling[1:]):
        raise ValueError(f"TIFF JPEG components {sampling} do not match "
                         f"{spp} samples with sampling {want} (libtiff: "
                         f"improper JPEG sampling factors): {where}")
    if px.shape[1] != cols or px.shape[0] < rows:
        raise ValueError(f"TIFF JPEG strip or tile is {px.shape[1]}x"
                         f"{px.shape[0]}, expected {cols}x{rows}: {where}")
    if bits == 8:
        return px[:rows]
    v = px[:rows].reshape(rows, -1).astype(np.int64)
    pairs = v.shape[1] // 2
    packed = np.zeros((rows, (v.shape[1] * 12 + 7) // 8), np.uint8)
    a, b = v[:, 0:2 * pairs:2], v[:, 1:2 * pairs:2]
    packed[:, 0:3 * pairs:3] = a >> 4
    packed[:, 1:3 * pairs:3] = ((a & 15) << 4) | (b >> 8)
    packed[:, 2:3 * pairs:3] = b & 255
    return _samples(packed.tobytes(), rows, cols, spp, 12, bo, where)


# libtiff's putcontig8bitYCbCr routines: the subsamplings it converts
_YCBCR_BLOCKS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _ycbcr_units(raw: bytes, rows: int, cols: int, sub, where: str,
                 visible: int):
    """Subsampled YCbCr data units (hs x vs Y samples, then Cb and Cr) ->
    (rows, cols, 3) with each unit's Cb and Cr on all its pixels, as
    libtiff's RGBA interface reads them. Of a tile whose right part lies
    past the image (`visible` columns inside it), putcontig8bitYCbCr44tile
    skips (cols - visible) // 4 units of 10 bytes, not 18, after each unit
    row: its later unit rows are read from that many bytes too early."""
    hs, vs = sub
    across, down = -(-cols // hs), -(-rows // vs)
    n = hs * vs + 2
    if len(raw) < across * down * n:
        raise ValueError(f"TIFF YCbCr data too short: {where}")
    flat = np.frombuffer(raw, np.uint8, across * down * n)
    if sub == (4, 4) and cols - visible >= 4:
        inside = -(-visible // 4)
        step = inside * n + (cols - visible) // 4 * 10
        at = (np.arange(down) * step)[:, None] + np.arange(inside * n)
        u = np.zeros((down, across, n), np.uint8)
        u[:, :inside] = flat[at].reshape(down, inside, n)
    else:
        u = flat.reshape(down, across, n)
    y = u[..., :hs * vs].reshape(down, across, vs, hs).transpose(
        0, 2, 1, 3).reshape(down * vs, across * hs)
    c = np.repeat(np.repeat(u[..., hs * vs:], vs, axis=0), hs, axis=1)
    return np.concatenate((y[..., None], c), axis=2)[:rows, :cols]


def ycbcr_to_rgb(ycc: np.ndarray, tags) -> np.ndarray:
    """tif_color.c TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB: (..., 3) u8
    YCbCr -> RGB with the file's YCbCrCoefficients and
    ReferenceBlackWhite (libtiff's defaults 0.299, 0.587, 0.114 and 0,
    255, 128, 255, 128, 255), in single-precision floats and 16-bit fixed
    point."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(YCBCRCOEFFICIENTS,
                                     (0.299, 0.587, 0.114))]
    rbw = [f32(v) for v in tags.get(REFERENCEBLACKWHITE,
                                    (0, 255, 128, 255, 128, 255))]

    def fix(v):
        return int(float(min(max(v, f32(0)), f32(2))) * 65536 + 0.5)

    def code2v(c, rb, rw, cr):
        den = rw - rb
        num = (c - np.int64(int(rb))).astype(f32) * f32(cr)
        v = num / (den if den != 0 else f32(1))
        return np.clip(v, f32(-4096), f32(4096)).astype(np.int64)
    lr, lg, lb = luma
    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)
    x = np.arange(256, dtype=np.int64) - 128
    cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    yy, b_, r_ = (ycc[..., k].astype(np.int64) for k in range(3))
    y = y_tab[yy]
    rgb = np.stack([y + cr_r[r_], y + ((cb_g[b_] + cr_g[r_]) >> 16),
                    y + cb_b[b_]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _raw_rgbx(buf: bytes, offsets, w: int, h: int, cw: int, ch: int,
              where: str) -> np.ndarray:
    """Uncompressed 3-sample YCbCr as PIL reads it: its raw decoder, given
    OPEN_INFO's raw mode RGBX, takes 4 bytes a pixel from each strip or
    tile (and the rows after it), unconverted; data past the file is
    PIL's truncation error."""
    if cw == w and ch >= h:
        offsets = offsets[-1:]
    out = np.zeros((h, w, 3), np.uint8)
    x = y = 0
    for off in offsets:
        cols, rows = min(x + cw, w) - x, min(y + ch, h) - y
        nbytes = 4 * cols
        stride = cw * 3 if x + cw > w else nbytes
        if stride < nbytes:
            raise ValueError(f"TIFF YCbCr tile row shorter than PIL's RGBX "
                             f"row (PIL: decoder error): {where}")
        if off + stride * (rows - 1) + nbytes > len(buf):
            raise ValueError(f"TIFF uncompressed YCbCr read as RGBX runs "
                             f"past the file (PIL: image file is truncated): "
                             f"{where}")
        data = np.frombuffer(buf, np.uint8, stride * (rows - 1) + nbytes, off)
        rgbx = np.lib.stride_tricks.as_strided(
            data, (rows, cols, 4), (stride, 4, 1))
        out[y:y + rows, x:x + cols] = rgbx[..., :3]
        x += cw
        if x >= w:
            x, y = 0, y + ch
            if y >= h:
                break
    return out


def _orient(rgba: np.ndarray, tags) -> np.ndarray:
    """ImageOps.exif_transpose by the Orientation tag, as PIL's TIFF
    plugin applies it after loading."""
    o = _scalar(tags, ORIENTATION, 1)
    t = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
         4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
         6: lambda a: np.rot90(a, -1), 8: lambda a: np.rot90(a),
         7: lambda a: a[::-1, ::-1].transpose(1, 0, 2)}.get(o)
    return rgba if t is None else np.ascontiguousarray(t(rgba))


def _convert(mode, how, s, bits, tags, where) -> np.ndarray:
    """Samples -> RGBA by the mode's unpacker and PIL's convert."""
    if mode in ("1", "L") and s.dtype == np.uint8:
        v = s[..., 0]
        if bits < 8 and mode == "L":
            v = v * (255 // ((1 << bits) - 1))
        if how == "invert":
            v = (1 - v) if mode == "1" else 255 - v
        return modes.to_rgba(mode, v.astype(np.uint8))
    if mode in ("I;16", "I"):
        v = s[..., 0].astype(np.int64)
        if mode == "I" and bits == 16:
            v = np.where(v >= 32768, v - 65536, v)
        elif mode == "I" and bits == 32 and _scalar(tags, SAMPLEFORMAT,
                                                     1) == 2:
            v = np.where(v >= 2**31, v - 2**32, v)
        return modes.to_rgba(mode, v)
    if mode == "F":
        return modes.to_rgba("F", s[..., 0].astype(np.uint32).view(
            np.float32))
    if mode == "LAB":
        # the contiguous raw mode "LAB" takes a and b as signed bytes (+128)
        # and sets the fourth byte, which LittleCMS copies as alpha, to 255;
        # PIL's planes ("L", "A", "B") copy the bytes and leave it 0
        px = np.zeros(s.shape[:2] + (4,), np.uint8)
        px[..., :3] = s[..., :3]
        if how != "planar":
            px ^= np.array([0, 128, 128, 255], np.uint8)
        return modes.to_rgba("LAB", px)
    if bits == 16:
        s = (s >> 8).astype(np.uint8)
    if mode == "CMYK":
        return modes.to_rgba("CMYK", s[..., :4])
    if mode in ("P", "PA"):
        cmap = tags.get(COLORMAP)
        if cmap is None:
            raise ValueError(f"palette TIFF without a ColorMap: {where}")
        n = len(cmap) // 3
        pal = (np.asarray(cmap, np.int64).reshape(3, n).T >> 8).astype(
            np.uint8)
        px = s[..., 0] if mode == "P" else s[..., :2]
        return modes.to_rgba(mode, px, pal)
    if mode == "LA":
        return modes.to_rgba("LA", s)
    if how == "premultiplied":
        out = np.empty(s.shape[:2] + (4,), np.uint8)
        out[..., :3] = modes.unpremultiply(s[..., :3], s[..., 3],
                                           zero_alpha_black=True)
        out[..., 3] = s[..., 3]
        return out
    return modes.to_rgba(mode, s[..., :4] if mode == "RGBA" else s[..., :3])


def encode_tiff(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> an uncompressed little-endian TIFF in
    one strip (RGBA with ExtraSamples 2, unassociated alpha)."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    data = np.ascontiguousarray(img).tobytes()
    entries = [(WIDTH, 4, [w]), (LENGTH, 4, [h]), (BPS, 3, [8] * c),
               (COMPRESSION, 3, [1]), (PHOTOMETRIC, 3, [1 if c == 1 else 2]),
               (STRIPOFFSETS, 4, [0]), (SPP, 3, [c]), (ROWSPERSTRIP, 4, [h]),
               (STRIPBYTECOUNTS, 4, [len(data)]), (PLANAR, 3, [1])]
    if c == 4:
        entries.append((EXTRASAMPLES, 3, [2]))
    ifd_size = 2 + 12 * len(entries) + 4
    extra_at = 8 + ifd_size
    blobs, body = b"", []
    for tag, typ, vals in entries:
        fmt = "H" if typ == 3 else "I"
        packed = struct.pack("<" + fmt * len(vals), *vals)
        if len(packed) <= 4:
            body.append(struct.pack("<HHI", tag, typ, len(vals))
                        + packed.ljust(4, b"\0"))
        else:
            body.append(struct.pack("<HHII", tag, typ, len(vals),
                                    extra_at + len(blobs)))
            blobs += packed + b"\0" * (len(packed) & 1)
    data_at = extra_at + len(blobs)
    body[5] = struct.pack("<HHII", STRIPOFFSETS, 4, 1, data_at)
    return (b"II*\x00" + struct.pack("<I", 8)
            + struct.pack("<H", len(entries)) + b"".join(body)
            + b"\0\0\0\0" + blobs + data)
