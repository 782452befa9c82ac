"""TIFF reading and writing without PIL: the first page, as Pillow 12.1's
TiffImagePlugin.py opens it (``TiffImageFile._setup`` and its OPEN_INFO
table) and decodes it (its raw decoder for uncompressed data; libtiff's
TIFFReadEncodedStrip / TIFFReadEncodedTile, tif_lzw.c, tif_zip.c,
tif_packbits.c and tif_predict.c for the rest), converted as
``Image.convert("RGBA")`` converts it.

Covered: byte orders II and MM; strips and tiles; compression 1 (none), 5
(LZW), 8 and 32946 (Deflate, through zlib) and 32773 (PackBits);
predictor 1 and 2 (horizontal differencing on 8-, 16- and 32-bit samples;
like PIL, uncompressed data ignores the predictor, and so does PackBits,
which libtiff runs without one); FillOrder 2 where PIL's table has it;
planar configuration 1 and 2 (compressed LA and PA planes come out
with alpha 0, as PIL's libtiff decoder leaves them); photometric 0
(WhiteIsZero) and 1 (BlackIsZero) at 1, 2, 4, 8, 16 and 32 bits, 2 (RGB) at 8 and 16 bits
with ExtraSamples 0 (ignored), 1 (associated alpha, PIL's RGBa: rgb * 255
// a at unpack time, black where a is 0) and 2 (unassociated alpha), and
3 (palette) at 1, 2, 4 and 8 bits with a 16-bit ColorMap (its high
bytes), with or without an alpha sample.

PIL's quirks are kept: 16-bit grey is I;16 (clipped at 255, WhiteIsZero
not inverted), 16-bit colour keeps each sample's high byte, an RGB image
with a fourth sample and no ExtraSamples is RGBA, 8-bit samples marked
signed read as unsigned. What PIL refuses raises ValueError naming it;
so does what the port does not read yet: JPEG compression (6, 7), CCITT
(2, 3, 4), LZMA, ZSTD, WebP and other codecs; float samples (SampleFormat
3) and the floating-point predictor (3); 12-bit samples; photometric 4
and up (CMYK, YCbCr, CIELab and the rest); BigTIFF; an Orientation of 5
to 8 (PIL swaps the size); old-style LZW.

Write: L, RGB and RGBA (ExtraSamples 2), uncompressed, little-endian, one
strip, which PIL reads back as the same mode and pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import lzw, modes

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
 EXTRASAMPLES, SAMPLEFORMAT) = (256, 257, 258, 259, 262, 266, 273, 274,
                                277, 278, 279, 284, 317, 320, 322, 323,
                                324, 325, 338, 339)


def looks_like_tiff(head: bytes) -> bool:
    """PIL's prefixes: II or MM with 42 (or the two byte-swapped forms),
    and BigTIFF's 43."""
    return head[:4] in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                        b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")


def _first_ifd(buf: bytes, where: str) -> tuple[str, dict]:
    bo = "<" if buf[:2] == b"II" else ">"
    if buf[2:4] in (b"\x2b\x00", b"\x00\x2b"):
        raise ValueError(f"BigTIFF is not read by the port: {where}")
    (off,) = struct.unpack_from(bo + "I", buf, 4)
    if off + 2 > len(buf):
        raise ValueError(f"TIFF IFD offset past the file: {where}")
    (n,) = struct.unpack_from(bo + "H", buf, off)
    tags = {}
    for i in range(n):
        e = off + 2 + 12 * i
        if e + 12 > len(buf):
            raise ValueError(f"TIFF IFD truncated: {where}")
        tag, typ, count = struct.unpack_from(bo + "HHI", buf, e)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize("<" + fmt) * count
        pos = e + 8 if size <= 4 else struct.unpack_from(bo + "I", buf,
                                                          e + 8)[0]
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
    if photo in _PHOTOMETRIC or photo > 3:
        name = _PHOTOMETRIC.get(photo, str(photo))
        raise ValueError(f"TIFF photometric {photo} ({name}) is not read by "
                         f"the port: {where}")
    if fmt == (3,):
        raise ValueError(f"TIFF float samples (SampleFormat 3) are not read "
                         f"by the port: {where}")
    if photo in (0, 1) and n == 1 and not extra:
        b = bps[0]
        if b in (1, 2, 4) and fmt == (1,):
            return ("1" if b == 1 else "L"), ("invert" if photo == 0 else "")
        if b == 8 and (fmt == (1,) or (fmt == (2,) and photo == 1)):
            if fill == 2 and fmt == (2,):
                raise ValueError(f"TIFF unknown pixel mode: {where}")
            return "L", "invert" if photo == 0 else ""
        if b == 12:
            raise ValueError(f"TIFF 12-bit samples are not read by the "
                             f"port: {where}")
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
    if bits >= 8:
        dt = {8: np.uint8, 16: np.dtype(bo + "u2"), 32: np.dtype(bo + "u4")}
        return b.copy().view(dt[bits])[:, :width * spp].reshape(
            rows, width, spp)
    bit = np.unpackbits(b, axis=1)[:, :width * spp * bits]
    w = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (bit.reshape(rows, width * spp, bits) * w).sum(-1).astype(
        np.uint8).reshape(rows, width, spp)


def read_tiff(buf: bytes, where: str = "<tiff>") -> np.ndarray:
    """TIFF bytes -> (H, W, 4) u8 of the first page, as PIL's
    Image.open(...).convert("RGBA") gives them."""
    if not looks_like_tiff(buf):
        raise ValueError(f"not a TIFF file: {where}")
    bo, tags = _first_ifd(buf, where)
    if 0xBC01 in tags:
        raise ValueError(f"Windows Media Photo in TIFF is not read: {where}")
    comp = _scalar(tags, COMPRESSION, 1)
    if comp not in (1, 5, 8, 32773, 32946):
        name = _COMPRESSIONS.get(comp, str(comp))
        raise ValueError(f"TIFF compression {comp} ({name}) is not read by "
                         f"the port: {where}")
    planar = _scalar(tags, PLANAR, 1)
    photo = _scalar(tags, PHOTOMETRIC, 0)
    fill = _scalar(tags, FILLORDER, 1)
    if WIDTH not in tags or LENGTH not in tags:
        raise ValueError(f"TIFF without its dimensions: {where}")
    w, h = tags[WIDTH][0], tags[LENGTH][0]
    if _scalar(tags, ORIENTATION, 1) in (5, 6, 7, 8):
        raise ValueError(f"TIFF Orientation {tags[ORIENTATION][0]} (PIL "
                         f"swaps the size) is not read by the port: {where}")
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
    bits = bps[0]
    if len(set(bps)) != 1:
        raise ValueError(f"TIFF samples of mixed sizes {bps}: {where}")
    predictor = _scalar(tags, PREDICTOR, 1)
    if comp in (5, 8, 32946) and predictor != 1:
        if predictor != 2:
            raise ValueError(f"TIFF predictor {predictor} is not read by the "
                             f"port: {where}")
        if bits < 8:
            raise ValueError(f"TIFF horizontal predictor at {bits} bits "
                             f"(libtiff refuses it): {where}")
    else:
        predictor = 1
    if planar == 2 and comp != 1 and mode == "RGB" and spp > 3:
        raise ValueError(f"planar TIFF with an ignored extra sample (PIL: "
                         f"decoder error): {where}")
    if planar == 2 and comp == 1 and not (bits == 8 and how == "" and
                                          mode in ("RGB", "RGBA")):
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
    planes = spp if planar == 2 else 1
    per_chunk = spp // planes
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) < across * down * planes:
        raise ValueError(f"TIFF has {len(offsets)} strips or tiles, the "
                         f"image needs {across * down * planes}: {where}")
    dt = np.uint8 if bits <= 8 else np.uint32 if bits == 32 else np.uint16
    out = np.zeros((h, w, spp), dt)
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                k = (p * down + ty) * across + tx
                rows = ch if tiled else min(ch, h - ty * ch)
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
                if comp == 5:
                    raw = lzw.decode_tiff(raw, need)
                elif comp in (8, 32946):
                    try:
                        raw = zlib.decompressobj().decompress(raw, need)
                    except zlib.error as e:
                        raise ValueError(f"TIFF Deflate data does not "
                                         f"inflate ({e}): {where}") from None
                elif comp == 32773:
                    raw = _packbits(raw, need)
                s = _samples(raw, rows, cw, per_chunk, bits, bo, where)
                if predictor == 2:
                    s = np.cumsum(s.astype(np.uint64), axis=1).astype(s.dtype)
                y0, x0 = ty * ch, tx * cw
                y1, x1 = min(y0 + rows, h), min(x0 + cw, w)
                out[y0:y1, x0:x1, p:p + per_chunk] = s[:y1 - y0, :x1 - x0]
    if planar == 2 and mode in ("LA", "PA"):
        # PIL's libtiff decoder puts each plane in the band of its index;
        # these modes keep alpha in band 3, which stays 0
        out[..., 1] = 0
    return _convert(mode, how, out, bits, tags, where)


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
    if bits == 16:
        s = (s >> 8).astype(np.uint8)
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
