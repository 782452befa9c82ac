"""Texture image IO without PIL or imageio (plainrenderer_tpu/assets/
image_io.py).

The JAX package reads images through PIL and imageio (the reference's stb
loader, Plain/src/Common/ImageIO.cpp:17-116); the card's machine has
neither, so the port carries its own readers on numpy and the standard
library. ``load_image`` picks the reader by the file's content, as
``PIL.Image.open`` does (magic bytes; TGA, which has none, by its suffix
and PIL's header check), and every reader returns what
``np.asarray(Image.open(path).convert("RGBA"))`` gives, bit for bit
(assets/modes.py holds PIL's mode conversions):

  - PNG: chunks and CRCs with `struct` and `zlib`, the five scanline
    filters in numpy (undone along anti-diagonals, so Average and Paeth
    rows need no per-pixel Python loop), colour types 0, 2, 3, 4 and 6 at
    every bit depth the format allows, Adam7 interlacing; 16-bit samples
    keep their high byte (16-bit grey clips to 255), a tRNS chunk gives
    alpha as PIL applies it;
  - JPEG (assets/jpeg.py), BMP and bare DIB (assets/bmp.py), GIF's
    first frame (assets/gif.py), TIFF's first page (assets/tiff.py), TGA
    (assets/tga.py), PBM / PGM / PPM and PIL's PNM extensions (Pf,
    P0CMYK, PyP, PyRGBA, PyCMYK; assets/pnm.py), WebP (assets/webp.py),
    PSD's merged image (assets/psd.py), QOI (assets/qoi.py), SGI
    (assets/sgi.py), PCX and DCX's first page (assets/pcx.py), ICO and
    CUR (assets/ico.py), DDS by content under any other suffix than .dds
    (BC1-BC5 through assets/bcn.py, BC6H through assets/bc6h.py, BC7
    through assets/bc7.py; assets/dds.py), XBM, XPM, PIXAR, XV
    thumbnails, IM Tools, McIdas, GIMP brushes, MSP and Sun rasters
    (assets/legacy.py), SPIDER and FITS (assets/spider_fits.py), IM
    (assets/im.py), FLI / FLC (assets/fli.py), BLP and FTEX
    (assets/blp.py), ICNS (assets/icns.py), PhotoCD (assets/pcd.py),
    IPTC (assets/iptc.py), JPEG 2000 codestreams and JP2 / JPX files
    (assets/jp2.py over j2k_codestream.py, j2k_t2.py, j2k_t1.py and
    j2k_recon.py) and AVIF's first frame as libavif with dav1d decodes
    it (assets/avif.py over isobmff.py, the AV1 intra decoder
    av1_decode.py and avif_yuv.py), each within the limits its module
    states;
  - Radiance RGBE (.hdr, by suffix as in the JAX package): what the JAX
    package's imageio call returns here, OpenCV's reader at its default
    flags (``read_hdr``: its header rules, new-style run-length scanlines
    until one is flat; ``hdr_to_ldr``: its 8-bit conversion), as (H, W,
    4) f32 holding 0-255 with alpha 1;
  - DDS (.dds, by suffix) rgba8 textures through assets/dds.py.

Every reader but .dds and .hdr (which the JAX package reads without PIL)
applies PIL's decompression-bomb guard (``modes.check_size``) to the size
its header declares, before decoding anything: above 2 * 89,478,485
pixels ``modes.DecompressionBombError`` (a ValueError), above 89,478,485
a ``modes.DecompressionBombWarning``, with PIL's messages.

The readers are tried in the order of PIL's format list (``Image.ID``),
each where its magic bytes match; the formats without magic bytes (IM,
IM Tools, IPTC, PhotoCD, SPIDER) at their places in that order, each
raising modes.NotThisFormat where PIL's header check fails, and TGA last,
under its suffixes only. The formats PIL opens and cannot load here
either (BUFR, GRIB, HDF5, MPEG, EPS and WMF: stubs with no handler,
MPEG's missing decoder, EPS's Ghostscript, WMF's Windows renderer) raise
ValueError naming them (``_refuse``), and so does a feature of a format
above that the port does not read yet.

``save_image`` writes the format the suffix names from (H, W) and (H, W,
3|4) u8, as PIL's ``Image.fromarray(...).save(path)`` writes modes L, RGB
and RGBA: PNG (.png, .apng), BMP, DIB, TGA (.tga, .icb, .vda, .vst),
TIFF, PPM / PGM / PNM / PBM / PFM (P5 or P6, as PIL writes by mode), JPEG
(.jpg, .jpeg, .jpe, .jfif, and .mpo, which PIL writes as JPEG;
assets/jpeg_encode.py), QOI, SGI (.sgi, .rgb, .rgba, .bw), PCX, IM
(assets/im.py), DDS (assets/dds.py), GIF (assets/gif.py over
quantize.py and lzw.py), ICO and ICNS (assets/ico.py, icns.py over
resample.py), EPS and PS (assets/eps.py), PDF (assets/pdf.py, dated by
time.gmtime() as PIL dates it; RGBA as a JPEG 2000 image) and JPEG 2000
(.jp2, .j2k, .jpc, .jpf, .jpx, .j2c; PIL's lossless default through
assets/j2k_encode.py, a bare codestream where the file name ends in
".j2k" as PIL tests it, case and all, JP2 boxes from assets/jp2.py
otherwise), WebP (.webp; PIL's lossy default through
assets/webp_encode.py) and AVIF (.avif, .avifs; PIL's default through
assets/avif_write.py: libavif's YUV, container and libaom's frame rules
byte for byte, the AV1 tile data from the port's own intra search); what
PIL refuses to write (RGBA as JPEG, MPO, PCX, EPS or PS, grey as QOI, a
WebP side above 16383, an AVIF side above 65536) and any other suffix
raise ValueError and write nothing.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path

import numpy as np

from . import (avif, avif_write, blp, bmp, dds, eps, fli, gif, icns, ico, im, iptc,
               j2k_encode, jp2, jpeg, jpeg_encode, legacy, modes, pcd, pcx,
               pdf, pnm, psd, qoi, sgi, spider_fits, tga, tiff, webp,
               webp_encode)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel, and the bit depths the format allows
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
READ = ("PNG, JPEG, JPEG 2000, AVIF, BMP, DIB, GIF, TIFF, WebP, TGA, "
        "PBM/PGM/PPM/PFM, PSD, QOI, SGI, PCX/DCX, ICO/CUR, DDS, BLP, FTEX, "
        "FITS, FLI/FLC, GBR, "
        "ICNS, IM, IMT, IPTC, McIdas, MSP, PCD, PIXAR, SPIDER, Sun, XBM, "
        "XPM, XVThumb and Radiance .hdr")
SAVE_FORMATS = {".png": "PNG", ".apng": "PNG", ".bmp": "BMP", ".dib": "DIB",
                ".tga": "TGA", ".icb": "TGA", ".vda": "TGA", ".vst": "TGA",
                ".tif": "TIFF", ".tiff": "TIFF", ".ppm": "PPM", ".pgm": "PPM",
                ".pnm": "PPM", ".pbm": "PPM", ".pfm": "PPM", ".jpg": "JPEG",
                ".jpeg": "JPEG", ".jpe": "JPEG", ".jfif": "JPEG",
                ".qoi": "QOI", ".sgi": "SGI", ".rgb": "SGI", ".rgba": "SGI",
                ".bw": "SGI", ".pcx": "PCX", ".im": "IM", ".dds": "DDS",
                ".gif": "GIF", ".ico": "ICO", ".icns": "ICNS", ".eps": "EPS",
                ".ps": "EPS", ".pdf": "PDF", ".mpo": "JPEG",
                ".jp2": "JPEG2000", ".j2k": "JPEG2000", ".jpc": "JPEG2000",
                ".jpf": "JPEG2000", ".jpx": "JPEG2000", ".j2c": "JPEG2000",
                ".webp": "WEBP", ".avif": "AVIF", ".avifs": "AVIF"}
# formats PIL refuses for L, RGB and RGBA (BLP, MSP, XBM, PALM) or has no
# writer for here (BUFR, GRIB, HDF5, WMF)
_UNWRITTEN = {".blp": "BLP", ".msp": "MSP", ".xbm": "XBM", ".palm": "PALM",
              ".bufr": "BUFR", ".grib": "GRIB", ".h5": "HDF5",
              ".hdf": "HDF5", ".wmf": "WMF", ".emf": "WMF"}


def load_image(path: str | Path) -> np.ndarray:
    """Load an image as (H, W, 4): u8 for every LDR format, f32 for .hdr
    (image_io.py:16-41; 8-bit values, as the JAX package gets them here).
    Raises ValueError for a format or feature the port does not read, or
    for a malformed file, and modes.DecompressionBombError (a ValueError)
    where PIL's Image.open refuses the declared size."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".dds":
        img = dds.read_dds(path)
        if img.format != "rgba8":
            raise ValueError(f"only rgba8 DDS supported as 2D texture: {path}")
        arr = np.frombuffer(img.data, np.uint8)
        return arr[: img.height * img.width * 4].reshape(img.height, img.width, 4).copy()
    data = path.read_bytes()
    if suffix == ".hdr":
        return hdr_to_ldr(read_hdr(data, str(path)))
    return decode_image(data, str(path), suffix)


def decode_image(data: bytes, where: str = "<bytes>",
                 suffix: str = "") -> np.ndarray:
    """Image bytes -> (H, W, 4) u8 by the reader the content names (TGA
    only under one of its suffixes). A malformed file raises ValueError,
    whatever the reader tripped on."""
    for reader in _readers(data, suffix):
        try:
            return reader(data, where)
        except modes.NotThisFormat:
            continue  # Image.open tries the next format
        except (IndexError, KeyError, struct.error, zlib.error,
                OverflowError) as e:
            raise ValueError(f"malformed image file {where}: {e!r}") from e
    raise ValueError(f"image format {suffix or 'unknown'!r} is not read by "
                     f"the port ({READ} are): {where}")


def _refuse(name: str):
    def reader(data: bytes, where: str):
        raise ValueError(f"image format {name} is not read by the port "
                         f"(PIL opens it): {where}")
    return reader


def _wmf(data: bytes) -> bool:
    """WmfImagePlugin: a placeable metafile or an enhanced one."""
    return ((data.startswith(b"\xd7\xcd\xc6\x9a\x00\x00")
             and data[22:26] == b"\x01\x00\t\x00")
            or (data.startswith(b"\x01\x00\x00\x00")
                and data[40:44] == b" EMF"))


def _readers(data: bytes, suffix: str) -> list:
    """The decode functions whose magic bytes the content has, in the
    order of Image.open's format list; the formats without magic bytes
    at their places in it, and TGA, whose header check PIL runs on any
    file, last and only under one of its suffixes."""
    head = data[:16]
    claims = (
        (avif.accepts(data), avif.read_avif),
        (data.startswith((b"BLP1", b"BLP2")), blp.read_blp),
        (data.startswith(b"BM"), bmp.read_bmp),
        (bmp.looks_like_dib(data[:4]), bmp.read_dib),
        (data.startswith((b"BUFR", b"ZCZC")), _refuse("BUFR")),
        (data.startswith(ico.CUR_MAGIC), ico.read_cur),
        (pcx.looks_like_pcx(data[:2]), pcx.read_pcx),
        (pcx.looks_like_dcx(data[:4]), pcx.read_dcx),
        (data.startswith(b"DDS "), dds.read_dds_image),
        (data.startswith((b"%!PS", b"\xc5\xd0\xd3\xc6")), _refuse("EPS")),
        (data.startswith(b"SIMPLE"), spider_fits.read_fits),
        (fli.looks_like_fli(head), fli.read_fli),
        (data.startswith(b"FTEX"), blp.read_ftex),
        (legacy.looks_like_gbr(head), legacy.read_gbr),
        (data.startswith((b"GIF87a", b"GIF89a")), gif.read_gif),
        (data.startswith(b"GRIB") and data[7:8] == b"\x01", _refuse("GRIB")),
        (data.startswith(b"\x89HDF\r\n\x1a\n"), _refuse("HDF5")),
        (data.startswith(PNG_SIGNATURE), decode_png),
        (data.startswith((jp2.J2K_MAGIC, jp2.JP2_MAGIC)), jp2.read_jpeg2000),
        (data.startswith(b"icns"),
         lambda d, w: icns.read_icns(d, w, decode_png)),
        (data.startswith(ico.ICO_MAGIC), ico.read_ico),
        (True, im.read_im),
        (True, legacy.read_imt),
        (True, lambda d, w: iptc.read_iptc(d, w, decode_image)),
        (data.startswith(b"\xff\xd8\xff"), jpeg.decode_jpeg),
        (data.startswith(b"\0\0\0\0\0\0\0\x04"), legacy.read_mcidas),
        (data.startswith(b"\x00\x00\x01\xb3"), _refuse("MPEG")),
        (tiff.looks_like_tiff(data[:4]), tiff.read_tiff),
        (data.startswith((b"DanM", b"LinS")), legacy.read_msp),
        (pcd.looks_like_pcd(data), pcd.read_pcd),
        (data.startswith(b"\x80\xe8\x00\x00"), legacy.read_pixar),
        (pnm.looks_like_pnm(data[:2]), pnm.read_pnm),
        (data.startswith(psd.MAGIC), psd.read_psd),
        (data.startswith(qoi.MAGIC), qoi.read_qoi),
        (sgi.looks_like_sgi(data[:2]), sgi.read_sgi),
        (True, spider_fits.read_spider),
        (data.startswith(b"\x59\xa6\x6a\x95"), legacy.read_sun),
        (data[:4] == b"RIFF" and data[8:12] == b"WEBP", webp.read_webp),
        (_wmf(data), _refuse("WMF")),
        (legacy.looks_like_xbm(head), legacy.read_xbm),
        (data.startswith(b"/* XPM */"), legacy.read_xpm),
        (data.startswith(b"P7 332"), legacy.read_xvthumb),
        (suffix in tga.EXTENSIONS, tga.read_tga))
    return [reader for claimed, reader in claims if claimed]


def save_image(path: str | Path, image: np.ndarray) -> None:
    """Save (H, W) or (H, W, 3|4) u8 in the format the suffix names (case
    aside, SAVE_FORMATS); PIL's decode of the file equals its decode of
    PIL's own save of the array (RGBA as BMP reads back as RGB, as PPM is
    written as RGB, as PIL does), and every format but PNG, TIFF, ICO and
    ICNS (whose PNG entries use Python's zlib) is byte for byte PIL's.
    What PIL refuses to write and any other suffix raise ValueError and
    write no file."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix not in SAVE_FORMATS:
        name = _UNWRITTEN.get(suffix, repr(suffix or "no suffix"))
        raise ValueError(
            f"save_image does not write {name} ({path}); it writes "
            f"{', '.join(sorted(SAVE_FORMATS))}")
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        raise ValueError(f"save_image takes (H, W) or (H, W, 3|4) uint8, "
                         f"got {img.dtype} {img.shape}")
    encode = {"PNG": encode_png, "BMP": bmp.encode_bmp,
              "DIB": lambda a: bmp.encode_bmp(a)[14:],
              "TGA": tga.encode_tga, "TIFF": tiff.encode_tiff,
              "PPM": pnm.encode_pnm, "JPEG": jpeg_encode.encode_jpeg,
              "QOI": qoi.encode_qoi, "PCX": pcx.encode_pcx,
              "SGI": lambda a: sgi.encode_sgi(a, path.stem),
              "IM": lambda a: im.encode_im(a, path.name),
              "DDS": dds.encode_dds, "GIF": gif.encode_gif,
              "ICO": lambda a: ico.encode_ico(a, encode_png),
              "ICNS": lambda a: icns.encode_icns(a, encode_png),
              "EPS": eps.encode_eps,
              "PDF": lambda a: pdf.encode_pdf(a, path.stem),
              "JPEG2000": (j2k_encode.encode_j2k if path.name.endswith(".j2k")
                           else jp2.encode_jp2),
              "WEBP": webp_encode.encode_webp, "AVIF": avif_write.encode}
    path.write_bytes(encode[SAVE_FORMATS[suffix]](img))


# ------------------------------- PNG ---------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> grey, RGB or RGBA PNG bytes: every row
    with the Up filter, one zlib stream."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3|4) uint8, "
                         f"got {img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    up = np.empty((h, w * c + 1), np.uint8)
    up[:, 0] = 2
    up[0, 1:] = rows[0]
    up[1:, 1:] = rows[1:] - rows[:-1]  # u8 wraps: the Up filter
    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _png_chunks(data: bytes, where: str):
    """(type, body) of every chunk up to IEND, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"PNG ends before IEND: {where}")
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} truncated: {where}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC: {where}")
        pos += 12 + length
        yield kind, body
        if kind == b"IEND":
            return


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters of (h, 1 + stride) filtered rows (filter
    type first) with bpp bytes per complete pixel (1 below 8 bits).

    Filters predict a byte from its left (a), upper (b) and upper-left (c)
    neighbours, bpp bytes apart. A pixel therefore depends only on pixels
    of earlier anti-diagonals (row + pixel column), so each anti-diagonal
    is one vector step: the image is sheared so that diagonal d is column
    d of `s` (s[1 + y, 2 + y + p] holds pixel (y, p); row 0 and the
    columns left of each row stay 0, the neighbours outside the image)."""
    h = rows.shape[0]
    ftype = rows[:, 0]
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())} is not one of "
                         "the five")
    n = (rows.shape[1] - 1) // bpp
    raw = rows[:, 1:].reshape(h, n, bpp).astype(np.int16)
    if not ftype.any():
        return raw.astype(np.uint8).reshape(h, n * bpp)
    ys = np.arange(h)[:, None]
    cols = ys + np.arange(n)[None, :] + 2
    sraw = np.zeros((h, h + n + 1, bpp), np.int16)
    sraw[ys, cols - 1] = raw
    s = np.zeros((h + 1, h + n + 1, bpp), np.int16)
    f = ftype[:, None].astype(np.int16)
    for d in range(h + n - 1):
        y0, y1 = max(0, d - n + 1), min(h - 1, d)
        a = s[y0 + 1:y1 + 2, d + 1]
        b = s[y0:y1 + 1, d + 1]
        c = s[y0:y1 + 1, d]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        fd = f[y0:y1 + 1]
        pred = np.where(fd == 1, a, np.where(fd == 2, b, np.where(
            fd == 3, (a + b) >> 1, np.where(fd == 4, paeth, 0))))
        s[y0 + 1:y1 + 2, d + 2] = (sraw[y0:y1 + 1, d + 1] + pred) & 0xFF
    return s[ys + 1, cols].astype(np.uint8).reshape(h, n * bpp)


def _unpack_samples(rows: np.ndarray, width: int, channels: int,
                    depth: int) -> np.ndarray:
    """Unfiltered rows -> (h, width, channels) integer samples."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :width * channels].astype(
            np.uint16).reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * channels * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits.reshape(h, -1, depth) * weights).sum(axis=2)
    return vals.astype(np.uint8).reshape(h, width, channels)


def decode_png(data: bytes, where: str = "<bytes>",
               transparency: bool = True) -> np.ndarray:
    """PNG bytes -> (H, W, 4) u8, as PIL's convert("RGBA") gives them;
    without `transparency` a tRNS chunk is ignored (an ICO's PNG entry)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"not a PNG: {where}")
    header = palette = trns = None
    idat = []
    for kind, body in _png_chunks(data, where):
        if kind == b"IHDR" and len(body) == 13:
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS" and transparency:
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"PNG without IHDR or IDAT: {where}")
    w, h, depth, ctype, comp, filt, interlace = header
    if (ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype]
            or comp != 0 or filt != 0 or interlace > 1 or w == 0 or h == 0):
        raise ValueError(f"PNG header not supported (colour type {ctype}, "
                         f"depth {depth}, interlace {interlace}): {where}")
    if ctype == 3 and palette is None:
        raise ValueError(f"palette PNG without PLTE: {where}")
    modes.check_size(w, h)
    ch = _PNG_CHANNELS[ctype]
    bits_pp = ch * depth
    bpp = max(1, bits_pp // 8)
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate ({e}): "
                         f"{where}") from None
    samples = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits_pp + 7) // 8
        size = ph * (stride + 1)
        if pos + size > raw.size:
            raise ValueError(f"PNG image data truncated: {where}")
        rows = _unfilter(raw[pos:pos + size].reshape(ph, stride + 1), bpp)
        samples[y0::dy, x0::dx] = _unpack_samples(rows, pw, ch, depth)
        pos += size
    return _to_rgba(samples, ctype, depth, palette, trns)


def _to_rgba(samples, ctype: int, depth: int, palette, trns) -> np.ndarray:
    """Integer samples -> (H, W, 4) u8 by PIL's rules: 16-bit colour and
    alpha keep the high byte; grey below 8 bits scales to 0-255 and 16-bit
    grey clips at 255; a grey or RGB tRNS key is compared with the
    converted 8-bit value (a 1-bit key, nonzero, with 255); palette
    entries past the table are opaque black."""
    h, w, _ = samples.shape
    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        return modes.palette_table(palette, trns)[samples[..., 0]]
    if ctype in (0, 4):
        grey = samples[..., 0].astype(np.int64)
        if depth < 8:
            grey = grey * (255 // ((1 << depth) - 1))
        elif depth == 16:
            grey = grey >> 8 if ctype == 4 else np.minimum(grey, 255)
        out[..., :3] = grey[..., None]
        if ctype == 4:
            a = samples[..., 1]
            out[..., 3] = a >> 8 if depth == 16 else a
        else:
            out[..., 3] = 255
            if trns is not None and len(trns) >= 2:
                (key,) = struct.unpack(">H", trns[:2])
                if depth == 1:
                    key = 255 if key else 0
                out[..., 3][grey == key] = 0
        return out
    rgb = samples[..., :3]
    if depth == 16:
        rgb = rgb >> 8
    out[..., :3] = rgb
    if ctype == 6:
        a = samples[..., 3]
        out[..., 3] = a >> 8 if depth == 16 else a
    else:
        out[..., 3] = 255
        if trns is not None and len(trns) >= 6:
            key = np.asarray(struct.unpack(">3H", trns[:6]))
            out[..., 3][(rgb.astype(np.int64) == key).all(axis=-1)] = 0
    return out


# ------------------------------ Radiance -----------------------------

_HDR_DIMS = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


def _hdr_line(data: bytes, pos: int, where: str) -> tuple[bytes, int]:
    """C's fgets into a 128-byte buffer: up to and including the next
    newline, at most 127 bytes; nothing left is a read error."""
    if pos >= len(data):
        raise ValueError(f".hdr header ends early: {where}")
    nl = data.find(b"\n", pos, pos + 127)
    end = nl + 1 if nl >= 0 else min(len(data), pos + 127)
    return data[pos:end], end


def read_hdr(data: bytes, where: str = "<bytes>") -> np.ndarray:
    """Radiance RGBE bytes -> (H, W, 3) f32 radiance, each texel rgb *
    2^(e - 136), 0 where e is 0, as OpenCV's rgbe.cpp reads them (the
    decoder imageio picks for .hdr here): the header's lines up to a blank
    one must hold FORMAT=32-bit_rle_rgbe (EXPOSURE and other lines are
    ignored), the next line must start "-Y H +X W" (no other orientation)
    with H and W positive; widths of 8 to 32767 take new-style run-length
    scanlines until one does not start 2 2, from which texel on the rest
    of the image is flat; other widths are flat throughout."""
    if not data.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise ValueError(f"not a Radiance .hdr file: {where}")
    pos, found = 0, False
    while True:
        line, pos = _hdr_line(data, pos, where)
        if line in (b"", b"\n"):
            break
        found |= line == b"FORMAT=32-bit_rle_rgbe\n"
    if not found:
        raise ValueError(f".hdr header without FORMAT=32-bit_rle_rgbe "
                         f"before its blank line: {where}")
    line, pos = _hdr_line(data, pos, where)
    dims = _HDR_DIMS.match(line)
    if dims is None or int(dims[1]) <= 0 or int(dims[2]) <= 0:
        raise ValueError(f".hdr size line {line[:40]!r} is not -Y H +X W: "
                         f"{where}")
    h, w = int(dims[1]), int(dims[2])
    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.empty((h * w, 4), np.uint8)
    y = at = 0
    while 8 <= w <= 0x7FFF and y < h:
        head = buf[at:at + 4]
        if head.size < 4:
            raise ValueError(f".hdr data truncated: {where}")
        if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
            break  # flat from here on
        if (int(head[2]) << 8 | int(head[3])) != w:
            raise ValueError(f".hdr scanline {y} is not of width {w}: "
                             f"{where}")
        at += 4
        line = np.empty((4, w), np.uint8)
        for c in range(4):
            x = 0
            while x < w:
                if at + 2 > buf.size:
                    raise ValueError(f".hdr data truncated: {where}")
                count = int(buf[at])
                run = count > 128
                count -= 128 * run
                if count == 0 or count > w - x:
                    raise ValueError(f".hdr bad scanline data: {where}")
                if run:
                    line[c, x:x + count] = buf[at + 1]
                    at += 2
                else:
                    if at + 1 + count > buf.size:
                        raise ValueError(f".hdr data truncated: {where}")
                    line[c, x:x + count] = buf[at + 1:at + 1 + count]
                    at += 1 + count
                x += count
        rgbe[y * w:(y + 1) * w] = line.T
        y += 1
    rest = (h - y) * w * 4
    if buf.size - at < rest:
        raise ValueError(f".hdr data truncated: {where}")
    rgbe[y * w:] = buf[at:at + rest].reshape(-1, 4)
    rgbe = rgbe.reshape(h, w, 4)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - (128 + 8)),
                     0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def hdr_to_ldr(radiance: np.ndarray) -> np.ndarray:
    """(H, W, 3) f32 radiance -> (H, W, 4) f32 as the JAX package's
    load_image returns .hdr here: imageio's OpenCV reader at its default
    flags converts to 8 bits (saturate_cast<uchar>(v * 255.f): rounded
    half to even, clipped to 0-255, and 0 where the product passes 2^31,
    as cvRound's int32 overflows), which the JAX code casts to f32 and
    pads with alpha 1."""
    with np.errstate(over="ignore"):
        x = radiance * np.float32(255.0)
    u8 = np.where(x >= 2.0 ** 31, 0.0,
                  np.clip(np.rint(np.minimum(x, 2.0 ** 31)), 0, 255))
    out = np.ones(radiance.shape[:2] + (4,), np.float32)
    out[..., :3] = u8
    return out
