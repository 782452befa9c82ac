"""The port's readers of PIL's legacy formats (assets/bcn.py, legacy.py,
spider_fits.py, im.py, fli.py, blp.py, icns.py, pcd.py, iptc.py, dds.py's
DDS by content, pnm.py's PIL extensions, modes.py's LAB) and the writers
save_image gained (IM, DDS, DIB, PFM, the TGA suffixes, APNG), against
PIL, which the JAX package's load_image and save_image use:

  - every reader equals ``np.asarray(Image.open(p).convert("RGBA"))`` bit
    for bit, at several sizes (odd widths, 1 x 1), on files PIL writes
    (IM, XBM, MSP, SPIDER, DDS, BLP, ICNS, PFM) and on files this test
    builds from each format's layout for every branch PIL's plugin and C
    decoder take (BC1-BC5 blocks, Sun run-length, MSP rows, FLI chunks,
    IM's raw modes and bit decoder, FITS byte orders and gzip tiles,
    PhotoCD's YCC, IPTC bands, LAB in TIFF and PSD); where PIL refuses a
    file, or the port does not read a feature yet, ValueError names it;
  - the outcome of the JAX package's load_image and the port's under
    scenebuild's rule (an image, or an error that drops the slot) on one
    file per name in PIL's Image.ID, STILL_REFUSED aside;
  - save_image byte for byte as PIL's save; _load_texture_images against
    the JAX package's on maps in the new formats;
  - the committed fixtures in tests/data/formats_legacy, each beside
    PIL's decode as PNG (chip_smoke.py holds the port to those PNGs on
    the card's machine, which has no PIL). PhotoCD has no fixture: its
    smallest file is about 786 KB.

``python tests/test_torch_formats_legacy.py --write-fixtures`` regenerates
the fixtures. Numpy and PIL on small images; no frame is rendered.
"""

import gzip
import io
import itertools
import struct
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.assets import modes
from plainrenderer_tpu_torch.render import scenebuild as tsb
from test_torch_formats import _check, _picture, _pil, _refused, _save
from test_torch_formats_more import _dib, _icon_dir, _psd, _tiff_file

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
FIXTURES = Path(__file__).resolve().parent / "data" / "formats_legacy"
SIZES = ((1, 1), (7, 5), (33, 17))
# what PIL reads and the port refuses by name (name -> the words the
# port's ValueError holds); ROADMAP.md lists the same names (Queue 1 item
# 2.5). TIFF WebP and TIFF JPEG 2000 are refused by PIL too
# (tests/test_torch_formats_codecs.py). DDS BC6H and BC7 are read since
# slice 21 (tests/test_torch_formats_bcn.py) and AVIF now
# (tests/test_torch_formats_avif.py): none is left.
STILL_REFUSED: dict = {}
# names of PIL's Image.ID that are STILL_REFUSED formats
ID_REFUSED: dict = {}


def _rng(seed):
    return np.random.default_rng(seed)


def _same(data: bytes, suffix: str):
    """The port's outcome is PIL's: the same image, or both refuse (a Sun
    raster 1 or 2 pixels wide is a GIMP brush to PIL, which then reads
    it or not as its fields fall)."""
    want = _pil(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            tio.decode_image(data, "case", suffix)
    else:
        np.testing.assert_array_equal(tio.decode_image(data, "case", suffix),
                                      want)


def _u8(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


# --------------------------- DDS and BCn ----------------------------

def _dds(w, h, pfflags, fourcc=b"\0\0\0\0", bits=0, masks=(0, 0, 0, 0),
         dxgi=None):
    head = (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0)
            + bytes(44) + struct.pack("<II4sI", 32, pfflags, fourcc, bits)
            + struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0,
                                                       0, 0))
    return head + (b"" if dxgi is None else struct.pack("<5I", dxgi, 3, 0,
                                                        1, 0))


BCN = {b"DXT1": 8, b"DXT3": 16, b"DXT5": 16, b"BC4U": 8, b"ATI1": 8,
       b"BC5S": 16, b"BC5U": 16, b"ATI2": 16}
DXGI = {71: 8, 74: 16, 77: 16, 80: 8, 83: 16, 84: 16, 70: 8, 73: 16}


def _blocks(rng, w, h, size):
    """Random blocks, a third of BC1 colour halves in 3-colour mode."""
    n = ((w + 3) // 4) * ((h + 3) // 4)
    b = rng.integers(0, 256, (n, size), dtype=np.uint8)
    at = 0 if size == 8 else 8
    swap = rng.random(n) < 0.33
    lo = b[swap, at:at + 2].copy()
    b[swap, at:at + 2] = b[swap, at + 2:at + 4]
    b[swap, at + 2:at + 4] = lo
    return b.tobytes()


@pytest.mark.parametrize("size", SIZES + ((4, 4), (16, 8)))
def test_dds_block_formats_built_here(size):
    w, h = size
    rng = _rng(w * 31 + h)
    for fourcc, bs in BCN.items():
        _check(_dds(w, h, 4, fourcc) + _blocks(rng, w, h, bs), ".tex")
    for dxgi, bs in DXGI.items():
        _check(_dds(w, h, 4, b"DX10", dxgi=dxgi) + _blocks(rng, w, h, bs),
               ".tex")
    _check(_dds(w, h, 4, b"DX10", dxgi=28) + _u8(rng, 4 * w * h), ".tex")


@pytest.mark.parametrize("size", SIZES)
def test_dds_masks_luminance_palette_built_here(size):
    w, h = size
    rng = _rng(w + 7 * h)
    for bits, masks, pf in (
            (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 0x41),
            (24, (0xFF, 0xFF00, 0xFF0000, 0), 0x40),
            (16, (0xF800, 0x7E0, 0x1F, 0), 0x40),
            (16, (0x7C00, 0x3E0, 0x1F, 0x8000), 0x41),
            (16, (0xF00, 0xF0, 0xF, 0xF000), 0x41),
            (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), 0x41)):
        data = _u8(rng, w * h * bits // 8)
        _check(_dds(w, h, pf, bits=bits, masks=masks) + data, ".tex")
        # DdsRgbDecoder reads zeros past the end of the file
        _check(_dds(w, h, pf, bits=bits, masks=masks) + data[:len(data) // 2],
               ".tex")
    _check(_dds(w, h, 0x20000, bits=8) + _u8(rng, w * h), ".tex")
    _check(_dds(w, h, 0x20001, bits=16) + _u8(rng, 2 * w * h), ".tex")
    _check(_dds(w, h, 0x20, bits=8) + _u8(rng, 1024 + w * h), ".tex")


@pytest.mark.parametrize("size", SIZES)
def test_dds_written_by_pil(size):
    for mode, im in (("L", Image.fromarray(_picture(*size)[..., 0])),
                     ("RGB", Image.fromarray(_picture(*size))),
                     ("RGBA", Image.fromarray(_picture(*size, 4)))):
        _check(_save(im, "DDS"), ".bin")
        for fmt in ("DXT1", "DXT3", "DXT5", "BC3") if mode != "L" else ():
            _check(_save(im, "DDS", pixel_format=fmt), ".bin")
    _check(_save(Image.fromarray(_picture(*size)), "DDS",
                 pixel_format="BC5"), ".bin")


def test_dds_refusals_name_the_feature():
    """What PIL refuses in DDS content the port refuses, naming it; BC6H
    and BC7 (refused by name until slice 21) decode as PIL decodes them."""
    rng = _rng(1)
    for dxgi in (95, 96, 97, 98):
        _check(_dds(8, 8, 4, b"DX10", dxgi=dxgi) + _u8(rng, 64), ".tex")
    _refused(_dds(8, 8, 4, b"DX10", dxgi=72) + _u8(rng, 32), ".tex",
             "DXGI format 72", False)
    _refused(_dds(8, 8, 4, b"DXT1") + _u8(rng, 16), ".tex", "truncated",
             False)
    _refused(_dds(8, 8, 0x20000, bits=16) + _u8(rng, 128), ".tex",
             "luminance", False)


# ------------------------ the small formats -------------------------

def _xbm(w, h, rng, quirk=False):
    vals = rng.integers(0, 256, ((w + 7) // 8) * h)
    body = ",".join(("0x%X" if i % 3 else "0x%x") % v
                    for i, v in enumerate(vals))
    if quirk:  # a one-digit byte and an 'x' inside another byte's digits
        body = "0x1," + body.replace("0x0,", "0xx0,", 1)
    return (f"#define a_width {w}\n#define a_height {h}\n#define a_x_hot 1\n"
            f"#define a_y_hot 2\nstatic char a_bits[] = {{\n{body} }};\n"
            ).encode()


def _xpm(w, h, cpp, n, rng, none=False, header=True):
    chars = [chr(c) for c in range(35, 127) if chr(c) not in '"\\']
    keys = ["".join(t) for t in itertools.islice(
        itertools.product(chars, repeat=cpp), n)]
    lines = [f'"{w} {h} {n} {cpp}",']
    for i, k in enumerate(keys):
        colour = "None" if none and i == 1 else \
            f"#{int(rng.integers(0, 1 << 24)):06X}"
        lines.append(f'"{k} c {colour}",')
    idx = rng.integers(0, n, (h, w))
    if none:
        idx[idx == 1] = 0
    if header:
        lines.append("/* pixels */")
    lines += ['"' + "".join(keys[i] for i in row) + '",' for row in idx]
    return ("/* XPM */\nstatic char *x[] = {\n" + "\n".join(lines)
            + "\n};\n").encode()


def _pixar(w, h, rng, layout=(14, 2)):
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, *layout)
    return bytes(head) + _u8(rng, 3 * w * h)


def _mcidas(w, h, bpp, prefix, rng):
    ints = [0] * 64
    ints[1], ints[8], ints[9], ints[10] = 4, h, w, bpp
    ints[13], ints[14], ints[33] = 1, prefix, 256
    data = rng.integers(0, 256, (w * bpp + prefix) * h, dtype=np.uint8)
    if bpp > 1:
        data[::2] = rng.integers(0, 2, data[::2].size)
    return struct.pack(">64i", *ints) + data.tobytes()


def _gbr(w, h, depth, version, rng):
    comment = b"brush\0"
    size = (20 if version == 1 else 28) + len(comment)
    return (struct.pack(">5I", size, version, w, h, depth)
            + (b"GIMP" + struct.pack(">I", 10) if version == 2 else b"")
            + comment + _u8(rng, w * h * depth))


def _msp_header(magic, w, h):
    words = list(struct.unpack("<2H", magic)) + [w, h, 1, 1, 1, 1, w, h] \
        + [0] * 6
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return struct.pack("<16H", *words)


def _msp2(w, h, rng):
    stride = (w + 7) // 8
    rows, lengths = [], []
    for y in range(h):
        if y % 4 == 3:  # a row of length 0 is white
            lengths.append(0)
            continue
        row, left = b"", stride
        while left > 0:
            n = int(rng.integers(1, left + 1))
            row += bytes([0, n, int(rng.integers(0, 256))]) \
                if rng.random() < 0.5 else bytes([n]) + _u8(rng, n)
            left -= n
        rows.append(row)
        lengths.append(len(row))
    return (_msp_header(b"LinS", w, h) + struct.pack(f"<{h}H", *lengths)
            + b"".join(rows))


def _sun(w, h, depth, ftype, data, palette=None):
    pal = palette or b""
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), ftype,
                       1 if palette else 0, len(pal)) + pal + data


def _sun_rle(raw: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and raw[j] == raw[i] and j - i < 256:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, raw[i]])
            i = j
        else:
            out += b"\x80\x00" if raw[i] == 0x80 else raw[i:i + 1]
            i += 1
    return bytes(out)


def _sun_data(w, h, depth, ftype, rng):
    stride = ((w * depth + 15) // 16) * 2
    row = (w * depth + 7) // 8
    flat = np.repeat(rng.integers(0, 256, stride * h // 3 + 2,
                                  dtype=np.uint8), 3)
    flat[rng.random(flat.size) < 0.05] = 0x80
    return _sun_rle(flat[:row * h].tobytes()) if ftype == 2 \
        else flat[:stride * h].tobytes()


@pytest.mark.parametrize("size", SIZES + ((16, 3),))
def test_xbm_xpm_pixar_xv_built_here(size):
    w, h = size
    rng = _rng(w * 3 + h)
    _check(_save(Image.fromarray(_picture(w, h)[..., 0]).convert("1"),
                 "XBM"), ".xbm")
    _check(_xbm(w, h, rng), ".xbm")
    _check(_xbm(w, h, rng, quirk=True), ".xbm")
    for cpp in (1, 2, 3):
        _check(_xpm(w, h, cpp, 5, rng), ".xpm")
        _check(_xpm(w, h, cpp, 5, rng, none=True), ".xpm")
    _check(_xpm(w, h, 2, 300, rng), ".xpm")
    _check(_xpm(w, h, 1, 7, rng, header=False), ".xpm")
    _check(_pixar(w, h, rng), ".pxr")
    _check(b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n%d %d 255\n"
           % (w, h) + _u8(rng, w * h), ".xv")


@pytest.mark.parametrize("size", SIZES)
def test_imt_mcidas_gbr_built_here(size):
    w, h = size
    rng = _rng(w * 5 + h)
    data = _u8(rng, w * h)
    _check(b"width %d\nheight %d\npixel n8\n\x0c" % (w, h) + data, ".imt")
    _check(b"* comment\nheight %d\nwidth %d\npixel n8\n\x0c" % (h, w) + data,
           ".imt")
    for bpp in (1, 2, 4):
        for prefix in (0, 3):
            _check(_mcidas(w, h, bpp, prefix, rng), ".area")
    for depth in (1, 4):
        for version in (1, 2):
            _check(_gbr(w, h, depth, version, rng), ".gbr")


@pytest.mark.parametrize("size", SIZES)
def test_msp_and_sun_built_here(size):
    w, h = size
    rng = _rng(w * 11 + h)
    _check(_save(Image.fromarray(_picture(w, h)[..., 1]).convert("1"),
                 "MSP"), ".msp")
    _check(_msp2(w, h, rng), ".msp")
    for depth in (1, 4, 8, 24, 32):
        for ftype in (1, 2, 3):
            data = _sun_data(w, h, depth, ftype, rng)
            check = _same if w < 3 else _check
            check(_sun(w, h, depth, ftype, data), ".ras")
            if depth in (4, 8):
                pal = _u8(rng, 3 * (16 if depth == 4 else 200))
                check(_sun(w, h, depth, ftype, data, pal), ".ras")


def test_small_format_refusals_name_the_feature():
    rng = _rng(2)
    _refused(_xbm(16, 4, rng)[:-40], ".xbm", "XBM data truncated", False)
    _refused(_xpm(4, 4, 1, 5, rng).replace(b"c #", b"c red#", 1), ".xpm",
             "XPM colour", False)
    _refused(_xpm(4, 4, 2, 300, rng, none=True), ".xpm", "transparent",
             False)
    _refused(b"width 4\nheight 4\npixel n8\n", ".imt", "without pixels",
             False)
    _refused(_gbr(4, 4, 4, 2, rng)[:-3], ".gbr", "GIMP brush", False)
    _refused(_sun(8, 8, 8, 2, _sun_rle(bytes(range(40)))), ".ras",
             "run-length data truncated", False)
    _refused(_msp2(9, 5, rng)[:-2], ".msp", "MSP row", False)


# ------------------------- SPIDER and FITS --------------------------

def _card(s):
    return s.ljust(80).encode()


def _fits(bitpix, w, h, data, naxis=2):
    head = _card("SIMPLE  =                    T / comment") \
        + _card(f"BITPIX  = {bitpix}") + _card(f"NAXIS   = {naxis}")
    head += _card(f"NAXIS1  = {w * h if naxis == 1 else w}")
    if naxis == 2:
        head += _card(f"NAXIS2  = {h}")
    return (head + _card("END")).ljust(2880, b" ") + data


def _fits_gzip(bitpix, w, h, values):
    primary = (_card("SIMPLE  = T") + _card("BITPIX  = 8")
               + _card("NAXIS   = 0") + _card("END")).ljust(2880, b" ")
    ext = (_card("XTENSION= 'BINTABLE'") + _card("BITPIX  = 8")
           + _card("NAXIS   = 2") + _card("NAXIS1  = 8")
           + _card("NAXIS2  = 2") + _card("ZIMAGE  = T")
           + _card("ZCMPTYPE= 'GZIP_1  '") + _card(f"ZBITPIX = {bitpix}")
           + _card("ZNAXIS  = 2") + _card(f"ZNAXIS1 = {w}")
           + _card(f"ZNAXIS2 = {h}") + _card("END")).ljust(2880, b" ")
    return primary + ext + bytes(16) + gzip.compress(values, mtime=0)


@pytest.mark.parametrize("size", SIZES)
def test_spider_and_fits(size):
    w, h = size
    rng = _rng(w * 13 + h)
    f = rng.normal(100, 120, (h, w)).astype(np.float32)
    f.flat[0] = np.nan
    spider = _save(Image.fromarray(f, "F"), "SPIDER")
    _check(spider, ".spi")
    n = int(np.frombuffer(spider[:108], "<f4")[21])  # labbyt
    _check(np.frombuffer(spider[:n], "<f4").astype(">f4").tobytes()
           + f.astype(">f4").tobytes(), ".spi")
    stack = np.frombuffer(spider[:n], "<f4").copy()
    stack[23], stack[25] = 2, 1  # istack > 0: the first image of a stack
    _check(stack.tobytes() + spider[:n] + f.astype("<f4").tobytes(), ".spi")
    for bitpix, dt in ((8, "u1"), (16, ">i2"), (32, ">i4"), (-32, ">f4"),
                       (-64, ">f8")):
        d = (rng.integers(0, 300, (h, w)) if bitpix > 0
             else rng.normal(100, 100, (h, w))).astype(dt).tobytes()
        _check(_fits(bitpix, w, h, d + bytes(-len(d) % 2880)), ".fits")
        _check(_fits(bitpix, w, h, d), ".fits")  # PIL's offset quirk
    _check(_fits(8, w, h, _u8(rng, max(w * h, 80)), naxis=1), ".fits")
    values = rng.integers(0, 2 ** 31, (h, w)).astype(">i4").tobytes()
    for bitpix in (8, 16, 32):  # fewer than 80 bytes of tiles: PIL's
        # offset quirk starts them early, and both refuse the file
        (_check if w * h > 32 else _same)(_fits_gzip(bitpix, w, h, values),
                                          ".fits")


def test_spider_and_fits_refusals_name_the_feature():
    _refused(_fits_gzip(-32, 4, 4, bytes(64)), ".fits", "gzip", False)
    _refused((_card("SIMPLE  = T") + _card("BITPIX  = 8")
              + _card("NAXIS   = 0") + _card("END")).ljust(2880, b" "),
             ".fits", "truncated", False)


# -------------------------------- IM --------------------------------

def _im(kind, w, h, data, lut=None, crlf=True):
    nl = "\r\n" if crlf else "\n"
    head = (f"Image type: {kind}{nl}Name: x{nl}Image size (x*y): {w}*{h}"
            f"{nl}").encode() + (b"Lut: 1\r\n" if lut is not None else b"")
    return head + bytes(511 - len(head)) + b"\x1a" + (lut or b"") + data


IM_TYPES = ("0 1 image", "Greyscale image", "RGB image", "B2 image",
            "B4 image", "X 24 image", "L 32 S image", "L 32 F image",
            "RGB3 image", "RYB3 image", "LA image", "RGBA image",
            "RGBX image", "CMYK image", "YCC image", "L 8S image",
            "L 16 image", "L 16S image", "L 32F image", "L 16B image",
            "L*16 image", "L 32S image", "L*3 image", "L*12 image",
            "L*31 image")


@pytest.mark.parametrize("size", SIZES)
def test_im_built_here(size):
    w, h = size
    rng = _rng(w * 17 + h)
    for kind in IM_TYPES:
        _check(_im(kind, w, h, _u8(rng, 8 * w * h + 64)), ".im")
    pal = _u8(rng, 768)
    grey = bytes(range(256)) * 3
    for kind in ("Greyscale image", "LA image", "PA image", "B4 image"):
        for lut in (pal, grey):  # PA data with a grey palette: PIL fails
            _same(_im(kind, w, h, _u8(rng, 2 * w * h), lut), ".im")
    _check(_im("Greyscale image", w, h, _u8(rng, w * h), crlf=False), ".im")


@pytest.mark.parametrize("size", SIZES)
def test_im_written_by_pil(size):
    a = _picture(*size, 4)
    for im in (Image.fromarray(a[..., 0]), Image.fromarray(a[..., :3]),
               Image.fromarray(a), Image.fromarray(a[..., 0]).convert("1"),
               Image.fromarray(a[..., :3]).quantize(30),
               Image.fromarray(a[..., :3]).convert("CMYK"),
               Image.fromarray(a[..., :3]).convert("YCbCr"),
               Image.fromarray(a[..., 0]).convert("F"),
               Image.fromarray(a[..., 0]).convert("I")):
        _check(_save(im, "IM"), ".im")


def test_im_refusals_name_the_feature():
    rng = _rng(3)
    for kind, name in (("RLB image", "RLB"), ("PA image", "PA;L"),
                       ("L*33 image", "image type"),
                       ("Foo image", "image type")):
        _refused(_im(kind, 4, 4, _u8(rng, 64)), ".im", name, False)
    _refused(_im("RGB image", 4, 4, _u8(rng, 20)), ".im", "truncated", False)


# -------------------------------- FLI -------------------------------

def _fli_header(w, h, magic=0xAF12):
    s = bytearray(128)
    struct.pack_into("<IHHHHHHI", s, 0, 0, magic, 1, w, h, 8, 3, 5)
    return bytes(s)


def _chunk(kind, data):
    data += b"\0" * (len(data) % 2)
    return struct.pack("<IH", 6 + len(data), kind) + data


def _frame(chunks):
    body = b"".join(chunks)
    return struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(chunks)) + body


def _fli_palette(rng, six_bit=False):
    if six_bit:  # skip 3 entries, set 10, skip 5, set 2 (values past 63)
        return (struct.pack("<H", 2) + bytes([3, 10]) + _u8(rng, 30)
                .translate(bytes(range(64)) * 4) + bytes([5, 2])
                + bytes(rng.integers(0, 70, 6).tolist()))
    return struct.pack("<H", 1) + bytes([0, 0]) + _u8(rng, 768)


def _brun(img, rng):
    out = b""
    for row in img:
        out += b"\0"
        x, w = 0, len(row)
        while x < w:
            n = int(rng.integers(1, min(w - x, 127) + 1))
            if rng.random() < 0.5:
                out += bytes([n, int(row[x])])
            else:
                out += bytes([256 - n]) + row[x:x + n].tobytes()
            x += n
    return out


def _lc(w, h, rng):
    y0 = int(rng.integers(0, h))
    lines = int(rng.integers(1, h - y0 + 1))
    out = struct.pack("<HH", y0, lines)
    for _ in range(lines):
        packets, x = [], 0
        while len(packets) < 6:
            skip = int(rng.integers(0, 4))
            if x + skip >= w:
                break
            x += skip
            n = int(rng.integers(1, min(w - x, 20) + 1))
            packets.append(bytes([skip, 256 - n, int(rng.integers(0, 256))])
                           if rng.random() < 0.5
                           else bytes([skip, n]) + _u8(rng, n))
            x += n
        out += bytes([len(packets)]) + b"".join(packets)
    return out


def _ss2(w, h, rng):
    lines, y = [], 0
    while y < h and len(lines) < h:
        words = b""
        if rng.random() < 0.3 and y + 2 < h:  # skip 2 rows
            words += struct.pack("<H", 65536 - 2)
            y += 2
        if rng.random() < 0.3:  # the row's last pixel
            words += struct.pack("<H", 0x8000 | int(rng.integers(0, 256)))
        packets, x = [], 0
        while len(packets) < 5:
            skip = int(rng.integers(0, 4))
            if x + skip + 2 > w:
                break
            x += skip
            n = int(rng.integers(1, max(1, (w - x) // 2) + 1))
            if x + 2 * n > w:
                break
            packets.append(bytes([skip, 256 - n]) + _u8(rng, 2)
                           if rng.random() < 0.5
                           else bytes([skip, n]) + _u8(rng, 2 * n))
            x += 2 * n
        lines.append(words + struct.pack("<H", len(packets))
                     + b"".join(packets))
        y += 1
    return struct.pack("<H", len(lines)) + b"".join(lines)


@pytest.mark.parametrize("size", SIZES + ((64, 40),))
def test_fli_chunks_built_here(size):
    w, h = size
    rng = _rng(w * 19 + h)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    for chunks in ([_chunk(4, _fli_palette(rng)), _chunk(15, _brun(img, rng))],
                   [_chunk(11, _fli_palette(rng, True)),
                    _chunk(16, img.tobytes())],
                   [_chunk(13, b""), _chunk(18, b"stamp")],
                   [_chunk(4, _fli_palette(rng)), _chunk(12, _lc(w, h, rng))],
                   [_chunk(4, _fli_palette(rng)), _chunk(7, _ss2(w, h, rng))],
                   [_chunk(16, img.tobytes()), _chunk(12, _lc(w, h, rng)),
                    _chunk(7, _ss2(w, h, rng))]):
        for magic in (0xAF12, 0xAF11):  # a chunk shorter than 10 bytes
            # (a 1 x 1 COPY) fails in PIL: held to the same outcome
            (_same if w == 1 else _check)(_fli_header(w, h, magic)
                                          + _frame(chunks), ".flc")


def test_fli_refusals_name_the_feature():
    rng = _rng(4)
    img = rng.integers(0, 256, (6, 8), dtype=np.uint8)
    frame = _frame([_chunk(15, _brun(img, rng))])
    _refused(_fli_header(8, 6) + frame[:-9], ".fli", "truncated", False)
    _refused(_fli_header(8, 6) + _frame([_chunk(99, b"abcd")]), ".fli",
             "chunk type 99", False)
    _refused(_fli_header(8, 6) + _frame([_chunk(16, img.tobytes()[:-8])]),
             ".fli", "COPY", False)
    _refused(_fli_header(8, 6) + _frame([_chunk(12, struct.pack(
        "<HH", 4, 5) + bytes(5))]), ".fli", "LC", False)


# ---------------------------- BLP, FTEX -----------------------------

def _blp2(w, h, encoding, alpha, alpha_encoding, data, rng):
    offset = 20 + 128 + 1024
    return (b"BLP2" + struct.pack("<ibbbbII", 1, encoding, alpha,
                                  alpha_encoding, 0, w, h)
            + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(data), *[0] * 15) + _u8(rng, 1024)
            + data)


def _blp1_palette(w, h, alpha, encoding, data, rng):
    return (b"BLP1" + struct.pack("<iIIIiI", 1, alpha, w, h, encoding, 0)
            + struct.pack("<16I", 9999, *[0] * 15)
            + struct.pack("<16I", len(data), *[0] * 15) + _u8(rng, 1024)
            + data)


def _blp1_jpeg(w, h, alpha, jpg):
    cut = 20  # the shared header: the first 20 bytes of the JPEG
    offset = 28 + 128 + 4 + cut + 7
    return (b"BLP1" + struct.pack("<iIIIiI", 0, alpha, w, h, 5, 0)
            + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(jpg) - cut, *[0] * 15)
            + struct.pack("<I", cut) + jpg[:cut] + bytes(7) + jpg[cut:])


def _ftex(w, h, fmt, data):
    return (b"FTEX" + struct.pack("<7i", 1, w, h, 1, 1, fmt, 32)
            + struct.pack("<i", len(data)) + data)


@pytest.mark.parametrize("size", SIZES + ((4, 4), (16, 8)))
def test_blp_and_ftex_built_here(size):
    w, h = size
    rng = _rng(w * 23 + h)
    n = ((w + 3) // 4) * ((h + 3) // 4)
    for alpha in (0, 1, 8):
        _check(_blp2(w, h, 1, alpha, 0, _u8(rng, w * h), rng), ".blp")
        for alpha_encoding, bs in ((0, 8), (1, 16), (7, 16)):
            _check(_blp2(w, h, 2, alpha, alpha_encoding, _u8(rng, n * bs),
                         rng), ".blp")
        for encoding in (4, 5):
            _check(_blp1_palette(w, h, alpha, encoding, _u8(rng, w * h + 3),
                                 rng), ".blp")
    a = Image.fromarray(_picture(w, h))
    for im in (a, a.convert("L"), a.convert("CMYK")):
        jpg = _save(im, "JPEG", quality=90)
        for alpha in (0, 1):
            _check(_blp1_jpeg(w, h, alpha, jpg), ".blp")
    ycck = bytearray(_save(a.convert("CMYK"), "JPEG", quality=90))
    ycck[ycck.find(b"Adobe") + 11] = 2  # BLP reads it as CMYK all the same
    _check(_blp1_jpeg(w, h, 0, bytes(ycck)), ".blp")
    for version in ("blp1", "blp2"):
        _check(_save(a.quantize(30), "BLP", blp_version=version), ".blp")
    _check(_ftex(w, h, 0, _blocks(rng, w, h, 8)), ".ftc")
    _check(_ftex(w, h, 1, _u8(rng, 3 * w * h)), ".ftu")


def test_blp_and_ftex_refusals_name_the_feature():
    rng = _rng(5)
    _refused(_blp2(8, 8, 2, 1, 3, _u8(rng, 64), rng), ".blp",
             "alpha encoding 3", False)
    _refused(_blp2(8, 8, 3, 1, 0, _u8(rng, 64), rng), ".blp", "encoding 3",
             False)
    _refused(_blp1_palette(8, 8, 0, 3, _u8(rng, 64), rng), ".blp",
             "encoding 3", False)
    _refused(_blp2(8, 8, 2, 0, 7, _u8(rng, 40), rng), ".blp", "truncated",
             False)
    _refused(_ftex(8, 8, 2, _u8(rng, 64)), ".ftc", "FTEX format 2", False)


# ------------------------------- ICNS -------------------------------

def _icns_rle(channel: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(channel)
    while i < n:
        j = i
        while j < n and channel[j] == channel[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            out += bytes([0x80 + (j - i) - 3, channel[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and channel[k] == channel[k + 1] == channel[k + 2]):
            k += 1
        k = max(k, i + 1)
        out += bytes([k - i - 1]) + channel[i:k]
        i = k
    return bytes(out)


def _icns(elements):
    body = b"".join(t + struct.pack(">I", 8 + len(d)) + d
                    for t, d in elements)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


ICNS_RGB = {16: (b"is32", b"s8mk"), 32: (b"il32", b"l8mk"),
            48: (b"ih32", b"h8mk"), 128: (b"it32", b"t8mk")}


@pytest.mark.parametrize("side", sorted(ICNS_RGB))
def test_icns_built_here(side):
    rng = _rng(side)
    code, mask_code = ICNS_RGB[side]
    img = np.repeat(rng.integers(0, 256, (side, side // 4, 3),
                                 dtype=np.uint8), 4, 1)
    img[rng.random((side, side)) < 0.1] = 7
    rle = b"".join(_icns_rle(img[..., c].tobytes()) for c in range(3))
    pre = bytes(4) if code == b"it32" else b""
    mask = _u8(rng, side * side)
    _check(_icns([(code, pre + rle), (mask_code, mask)]), ".icns")
    _check(_icns([(code, pre + rle)]), ".icns")
    _check(_icns([(code, pre + img.tobytes()), (mask_code, mask)]), ".icns")


def test_icns_png_elements_and_pil_files():
    rng = _rng(6)
    # PIL writes every size up to 1024 x 1024 as PNG (~2 s a file)
    _check(_save(Image.fromarray(rng.integers(0, 256, (16, 16, 4)).astype(
        np.uint8)), "ICNS"), ".icns")
    png = _save(Image.fromarray(rng.integers(0, 256, (64, 64, 3)).astype(
        np.uint8)).quantize(20), "PNG")
    _check(_icns([(b"ic07", png)]), ".icns")
    _check(_icns([(b"icp6", png), (b"is32", bytes(768))]), ".icns")


def test_icns_refusals_name_the_feature():
    """The ICNS refusals; a JPEG 2000 element, refused by name until the
    port read JPEG 2000, decodes as PIL decodes it."""
    rng = _rng(7)
    j2k = _save(Image.fromarray(rng.integers(0, 256, (32, 32, 3)).astype(
        np.uint8)), "JPEG2000")
    _check(_icns([(b"ic12", j2k)]), ".icns")
    png = _save(Image.fromarray(np.zeros((16, 16, 3), np.uint8)), "PNG")
    _refused(_icns([(b"ic07", png), (b"it32", b"\1\0\0\0xx")]), ".icns",
             "zero signature", False)
    _refused(_icns([(b"s8mk", bytes(256))]), ".icns", "mask without",
             False)


# ------------------------- PhotoCD, IPTC ----------------------------

def _pcd(y, cb, cr, orientation=0):
    body = b"".join(y[2 * k].tobytes() + y[2 * k + 1].tobytes()
                    + cb[k].tobytes() + cr[k].tobytes() for k in range(256))
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + body


def test_pcd_built_here():
    """The 768 x 512 base image under each orientation byte (PhotoCD has
    no committed fixture: its smallest file is about 786 KB)."""
    rng = _rng(8)
    for orientation in (0, 1, 2, 3):
        _check(_pcd(rng.integers(0, 256, (512, 768), dtype=np.uint8),
                    rng.integers(0, 256, (256, 384), dtype=np.uint8),
                    rng.integers(0, 256, (256, 384), dtype=np.uint8),
                    orientation), ".pcd")


def _iptc_field(record, dataset, data):
    if len(data) < 0x8000:
        return bytes([0x1C, record, dataset]) + struct.pack(">H",
                                                            len(data)) + data
    return bytes([0x1C, record, dataset, 0x84]) + struct.pack(
        ">I", len(data)) + data


def _iptc(w, h, layers, component, compression, img, band=None, split=1):
    out = (_iptc_field(3, 60, bytes([layers, component]))
           + _iptc_field(2, 5, b"title")
           + _iptc_field(3, 20, struct.pack(">H", w))
           + _iptc_field(3, 30, struct.pack(">I", h))
           + _iptc_field(3, 120, bytes([compression])))
    if band is not None:
        out += _iptc_field(3, 65, bytes([band]))
    k = len(img) // split + 1
    return out + b"".join(_iptc_field(8, 10, img[i * k:(i + 1) * k])
                          for i in range(split))


@pytest.mark.parametrize("size", SIZES)
def test_iptc_built_here(size):
    w, h = size
    rng = _rng(w * 29 + h)
    grey = rng.integers(0, 256, (h, w), dtype=np.uint8)
    _check(_iptc(w, h, 1, 0, 1, grey.tobytes()), ".iim")
    _check(_iptc(w, h, 1, 0, 1, grey.tobytes(), split=3), ".iim")
    for layers in (3, 4):
        for band in (None, 0, 2, 3):
            _check(_iptc(w, h, layers, 1, 1, grey.tobytes(), band), ".iim")
    jpg = _save(Image.fromarray(grey), "JPEG")
    _check(_iptc(w, h, 1, 0, 5, jpg), ".iim")
    _check(_iptc(w, h, 3, 1, 5, jpg, 2), ".iim")
    _check(_iptc(w, h, 1, 0, 5, _save(Image.fromarray(_picture(w, h)),
                                      "JPEG")), ".iim")


def test_iptc_refusals_name_the_feature():
    grey = bytes(16)
    _refused(_iptc(4, 4, 1, 0, 9, grey), ".iim", "compression", False)
    _refused(_iptc(4, 4, 1, 0, 1, grey[:-1]), ".iim", "truncated", False)
    _refused(_iptc(4, 4, 3, 1, 1, grey, 7), ".iim", "band 7", False)
    _refused(_iptc(4, 4, 3, 1, 5, _save(Image.fromarray(
        _picture(4, 4)), "JPEG"), 1), ".iim", "not grey", False)


# ---------------------- PNM extensions and LAB ----------------------

@pytest.mark.parametrize("size", SIZES)
def test_pnm_extensions(size):
    w, h = size
    rng = _rng(w * 37 + h)
    f = rng.normal(100, 100, (h, w)).astype(np.float32)
    _check(_save(Image.fromarray(f, "F"), "PPM"), ".pfm")
    for scale, dt in (("1.0", ">f4"), ("-1.0", "<f4"), ("-2.5", "<f4")):
        _check(b"Pf\n%d %d\n%s\n" % (w, h, scale.encode())
               + f[::-1].astype(dt).tobytes(), ".pfm")
    for magic, bands in ((b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyRGBA", 4),
                         (b"PyP", 1)):
        for maxval in (255, 100, 1000, 65535):
            v = rng.integers(0, maxval + 1, w * h * bands)
            _check(magic + b" %d %d %d\n" % (w, h, maxval) + v.astype(
                np.uint8 if maxval < 256 else ">u2").tobytes(), ".pnm")


def test_lab_conversion_is_littlecms():
    """modes.lab_to_rgb equals PIL's LAB -> RGB (LittleCMS) on the value
    the issue names, on the grid's corners and on 65,536 random values
    (the whole cube, 2^24 values, also matches; it takes ~20 s)."""
    rng = _rng(9)
    want = Image.new("LAB", (2, 2), (50, 10, 200)).convert("RGBA")
    assert want.getpixel((0, 0)) == (0, 71, 0, 255)
    np.testing.assert_array_equal(
        modes.to_rgba("LAB", np.array([[[50, 10, 200]]], np.uint8))[0, 0],
        (0, 71, 0, 255))
    lab = np.concatenate([
        rng.integers(0, 256, (65536, 3)),
        np.array(list(itertools.product((0, 1, 127, 128, 254, 255),
                                        repeat=3)))]).astype(np.uint8)
    raw = lab ^ np.array([0, 128, 128], np.uint8)  # PIL's raw mode LAB
    img = Image.frombytes("LAB", (1, len(lab)), raw.tobytes())
    np.testing.assert_array_equal(
        modes.lab_to_rgb(lab[:, None]), np.asarray(img.convert("RGB")))


@pytest.mark.parametrize("size", SIZES)
def test_lab_in_tiff_and_psd(size):
    w, h = size
    rng = _rng(w * 41 + h)
    lab = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for bo in ("<", ">"):
        for comp in (1, 8):
            for planar in (1, 2):
                planes = [lab] if planar == 1 else \
                    [lab[..., k] for k in range(3)]
                chunks = [p.tobytes() if comp == 1 else
                          zlib.compress(p.tobytes()) for p in planes]
                _check(_tiff_file(w, h, chunks, {
                    258: (3, [8, 8, 8]), 259: (3, [comp]), 262: (3, [8]),
                    277: (3, [3]), 278: (4, [h]), 284: (3, [planar])},
                    bo=bo), ".tif")
    for compression in (0, 1):
        for extra in (0, 1):
            planes = np.concatenate([lab.transpose(2, 0, 1), rng.integers(
                0, 256, (extra, h, w), dtype=np.uint8)])
            # an extra channel's PackBits row counts, which PIL does not
            # read, shift its planes: held to PIL's outcome
            (_same if extra else _check)(_psd(9, 8, planes, compression),
                                         ".psd")


# ------------------------ outcome parity ----------------------------

def _format_files() -> dict:
    """One small file per name in PIL's Image.ID."""
    rng = _rng(10)
    rgb = Image.fromarray(_picture(9, 7))
    w, h = 9, 7
    out = {
        "AVIF": _save(rgb, "AVIF"), "BLP": _blp2(w, h, 2, 8, 7, _u8(
            rng, 9 * 16), rng),
        "BMP": _save(rgb, "BMP"), "DIB": _save(rgb, "DIB"),
        "BUFR": b"BUFR" + bytes(60),
        "PCX": _save(rgb, "PCX"),
        "DCX": struct.pack("<II", 987654321, 12) + bytes(4)
        + _save(rgb, "PCX"),
        "DDS": _dds(w, h, 4, b"DXT5") + _blocks(rng, w, h, 16),
        "EPS": _save(rgb, "EPS"),
        "FITS": _fits(16, w, h, _u8(rng, 2880)),
        "FLI": _fli_header(w, h) + _frame([_chunk(4, _fli_palette(rng)),
                                           _chunk(16, _u8(rng, w * h))]),
        "FTEX": _ftex(w, h, 0, _blocks(rng, w, h, 8)),
        "GBR": _gbr(w, h, 4, 2, rng), "GIF": _save(rgb, "GIF"),
        "GRIB": b"GRIB\0\0\0\x01" + bytes(60),
        "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(60), "PNG": _save(rgb, "PNG"),
        "JPEG2000": _save(rgb, "JPEG2000"), "ICNS": _save(rgb, "ICNS"),
        "ICO": _save(Image.fromarray(_picture(16, 16)), "ICO"),
        "IM": _save(rgb, "IM"),
        "IMT": b"width %d\nheight %d\npixel n8\n\x0c" % (w, h)
        + _u8(rng, w * h),
        "IPTC": _iptc(w, h, 1, 0, 1, _u8(rng, w * h)),
        "JPEG": _save(rgb, "JPEG"), "MCIDAS": _mcidas(w, h, 2, 1, rng),
        "MPEG": b"\x00\x00\x01\xb3\x00\x90\x07" + bytes(60),
        "TIFF": _save(rgb, "TIFF"), "MSP": _msp2(w, h, rng),
        "PCD": _pcd(*(rng.integers(0, 256, s, dtype=np.uint8)
                      for s in ((512, 768), (256, 384), (256, 384)))),
        "PIXAR": _pixar(w, h, rng), "PPM": _save(rgb, "PPM"),
        "PSD": _psd(3, 8, _picture(w, h).transpose(2, 0, 1), 1),
        "QOI": _save(rgb, "QOI"), "SGI": _save(rgb, "SGI"),
        "SPIDER": _save(rgb.convert("F"), "SPIDER"),
        "SUN": _sun(w, h, 24, 2, _sun_data(w, h, 24, 2, rng)),
        "TGA": _save(rgb, "TGA"), "WEBP": _save(rgb, "WEBP"),
        "WMF": b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack(
            "<hhhhH", 0, 0, 90, 70, 72) + bytes(6) + b"\x01\x00\t\x00"
        + bytes(30),
        "XBM": _xbm(w, h, rng), "XPM": _xpm(w, h, 2, 6, rng),
        "XVTHUMB": b"P7 332\n#END_OF_COMMENTS\n%d %d 255\n" % (w, h)
        + _u8(rng, w * h)}
    out["CUR"] = _icon_dir(b"\0\0\2\0", [(16, 16, 0, 32, _dib(
        _picture(16, 16, 4), 32))])
    return out


def _outcome(load, path):
    """scenebuild's rule: an image, or None where the load raises."""
    try:
        return load(path)
    except (OSError, ValueError):
        return None


def test_outcome_parity_with_the_jax_package_over_pils_formats(tmp_path):
    """For every name in Image.ID, a file PIL identifies as that format:
    the port's load_image gives the JAX package's image, or both raise
    (the slot is dropped in both), except the STILL_REFUSED formats,
    which PIL reads and the port refuses by name."""
    Image.init()
    files = _format_files()
    assert set(files) == set(Image.ID)
    suffix = {"TGA": ".tga", "DDS": ".tex"}
    dropped = set()
    for name, data in files.items():
        with Image.open(io.BytesIO(data)) as im:
            assert im.format.upper() == name, (name, im.format)
        path = tmp_path / f"{name.lower()}{suffix.get(name, '.img')}"
        path.write_bytes(data)
        want = _outcome(jio.load_image, path)
        if name in ID_REFUSED:
            assert want is not None, name
            with pytest.raises(ValueError,
                               match=STILL_REFUSED[ID_REFUSED[name]]):
                tio.load_image(path)
            continue
        got = _outcome(tio.load_image, path)
        assert (got is None) == (want is None), name
        if want is None:
            dropped.add(name)
            with pytest.raises(ValueError, match=name):
                tio.load_image(path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert dropped == {"BUFR", "EPS", "GRIB", "HDF5", "MPEG", "WMF"}


def test_still_refused_matches_roadmap():
    """ROADMAP.md lists the formats and features the port still refuses,
    each under the STILL_REFUSED name this file uses."""
    text = (REPO / "ROADMAP.md").read_text()
    listed = text.split("STILL_REFUSED:", 1)[1].split("\n\n", 1)[0]
    names = {" ".join(n.split()) for n in listed.split(";")} - {""}
    assert names == set(STILL_REFUSED)


# ----------------------------- save_image ---------------------------

@pytest.mark.parametrize("suffix", [".im", ".dds", ".dib", ".pfm", ".icb",
                                    ".vda", ".vst", ".apng", ".IM"])
def test_save_image_writes_pils_bytes(tmp_path, suffix):
    """Byte for byte PIL's save (the IM header carries the file's name);
    .apng writes what .png writes."""
    rng = _rng(len(suffix))
    for shape in ((1, 1), (9, 13), (9, 13, 3), (9, 13, 4), (1, 7, 3),
                  (6, 130, 4)):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        ours = tmp_path / f"picture{suffix}"
        theirs = tmp_path / "pil" / f"picture{suffix}"
        theirs.parent.mkdir(exist_ok=True)
        tio.save_image(ours, a)
        Image.fromarray(a).save(theirs)
        if suffix == ".apng":
            assert ours.read_bytes() == tio.encode_png(a)
            np.testing.assert_array_equal(_pil(ours.read_bytes()),
                                          _pil(theirs.read_bytes()))
        else:
            assert ours.read_bytes() == theirs.read_bytes(), (shape, suffix)
        if suffix != ".dds":  # .dds loads by the JAX package's rgba8 rule
            np.testing.assert_array_equal(tio.load_image(ours),
                                          _pil(ours.read_bytes()))


def test_save_image_im_name_is_cut_as_pils(tmp_path):
    """The IM header's Name is the file's name, cut to 92 characters with
    its suffix kept, as PIL writes it."""
    a = _picture(5, 4)
    (tmp_path / "pil").mkdir()
    for name in ("x" * 120 + ".im", "b.c.im", "short.IM"):
        tio.save_image(tmp_path / name, a)
        Image.fromarray(a).save(tmp_path / "pil" / name)
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / "pil" / name).read_bytes(), name


# ------------------------ the slice against JAX ---------------------

MAP_FORMATS = ("im", "sun", "fits", "blp2_dxt5", "dds_bc3", "icns", "gbr",
               "fli", "xpm", "spider", "pfm")


def _map_file(a: np.ndarray, fmt: str, rng) -> bytes:
    """(48, 48, 3|4) u8 as `fmt`: PIL's save where PIL writes it, else
    built here from the format's layout."""
    h, w = a.shape[:2]
    rgba = np.dstack([a, np.full((h, w), 255, np.uint8)]) if a.shape[2] == 3 \
        else a
    if fmt == "im":
        return _save(Image.fromarray(a), "IM")
    if fmt == "sun":
        bgr = a[..., [2, 1, 0]].tobytes()
        return _sun(w, h, 24, 2, _sun_rle(bgr))
    if fmt == "fits":
        grey = a[..., 1].astype("<u2") * 3
        return _fits(16, w, h, grey[::-1].tobytes() + bytes(2880))
    if fmt == "blp2_dxt5":
        return _blp2(w, h, 2, 8, 7, _blocks(rng, w, h, 16), rng)
    if fmt == "dds_bc3":
        return _save(Image.fromarray(rgba), "DDS", pixel_format="DXT5")
    if fmt == "icns":  # 48 x 48: ih32's run-length channels and h8mk
        return _icns([(b"ih32", b"".join(_icns_rle(rgba[..., c].tobytes())
                                         for c in range(3))),
                      (b"h8mk", rgba[..., 3].tobytes())])
    if fmt == "gbr":
        return struct.pack(">5I", 28, 2, w, h, 4) + b"GIMP" + struct.pack(
            ">I", 10) + rgba.tobytes()
    if fmt == "fli":
        return _fli_header(w, h) + _frame([_chunk(4, _fli_palette(rng)),
                                           _chunk(15, _brun(a[..., 0].copy(),
                                                            rng))])
    if fmt == "xpm":
        return _xpm(w, h, 2, 300, rng)
    if fmt == "spider":
        return _save(Image.fromarray(a[..., 0]).convert("F"), "SPIDER")
    return _save(Image.fromarray(a[..., 0]).convert("F"), "PPM")  # pfm


@pytest.mark.parametrize("fmt", MAP_FORMATS)
def test_texture_images_match_jax(tmp_path, fmt):
    """render/scenebuild._load_texture_images on a mesh whose three maps
    are in `fmt` (DDS by content under .tex): an image in every slot,
    equal to the JAX package's."""
    rng = _rng(len(fmt))
    paths = {}
    for slot, name in (("albedo", "ivy_albedo"), ("normal", "ivy_normal"),
                       ("specular", "ivy_mr")):
        a = np.asarray(Image.open(DEMO / f"{name}.png").resize((48, 48)))
        p = tmp_path / f"{name}.{'tex' if fmt == 'dds_bc3' else fmt}"
        p.write_bytes(_map_file(a, fmt, rng))
        paths[slot] = str(p)
    paths = types.SimpleNamespace(**paths)
    got, want = tsb._load_texture_images(paths), \
        jsb._load_texture_images(paths)
    for slot in ("albedo", "normal", "specular"):
        g, w = getattr(got, slot), getattr(want, slot)
        assert w is not None and g is not None, (fmt, slot)
        np.testing.assert_array_equal(g, w, err_msg=f"{fmt} {slot}")


# ------------------------------ fixtures ----------------------------

def fixture_files() -> dict:
    """name -> bytes of the committed fixtures, one per new format or
    branch, small (16 x 12 and near it)."""
    rng = _rng(11)
    w, h = 17, 12
    rgb = _picture(w, h, 3, 31)
    rgba = _picture(w, h, 4, 32)
    img = Image.fromarray(rgb)
    out = {
        "dxt1.tex": _dds(w, h, 4, b"DXT1") + _blocks(rng, w, h, 8),
        "dxt3.tex": _dds(w, h, 4, b"DXT3") + _blocks(rng, w, h, 16),
        "bc3_dx10.tex": _dds(w, h, 4, b"DX10", dxgi=77)
        + _blocks(rng, w, h, 16),
        "bc4.tex": _dds(w, h, 4, b"ATI1") + _blocks(rng, w, h, 8),
        "bc5s.tex": _dds(w, h, 4, b"BC5S") + _blocks(rng, w, h, 16),
        "rgb565_masks.tex": _dds(w, h, 0x40, bits=16,
                                 masks=(0xF800, 0x7E0, 0x1F, 0))
        + _u8(rng, 2 * w * h),
        "pal8.tex": _dds(w, h, 0x20, bits=8) + _u8(rng, 1024 + w * h),
        "a.xbm": _save(Image.fromarray(rgb[..., 0]).convert("1"), "XBM"),
        "pal.xpm": _xpm(w, h, 1, 9, rng, none=True),
        "rgb300.xpm": _xpm(w, h, 2, 300, rng),
        "rgb.pxr": _pixar(w, h, rng),
        "thumb.xv": b"P7 332\n#END_OF_COMMENTS\n%d %d 255\n" % (w, h)
        + _u8(rng, w * h),
        "grey.imt": b"width %d\nheight %d\npixel n8\n\x0c" % (w, h)
        + _u8(rng, w * h),
        "i16.area": _mcidas(w, h, 2, 2, rng),
        "grey_v1.gbr": _gbr(w, h, 1, 1, rng),
        "rgba_v2.gbr": _gbr(w, h, 4, 2, rng),
        "v1.msp": _save(Image.fromarray(rgb[..., 1]).convert("1"), "MSP"),
        "v2_rle.msp": _msp2(w, h, rng),
        "bgr24_rle.ras": _sun(w, h, 24, 2, _sun_data(w, h, 24, 2, rng)),
        "pal8.ras": _sun(w, h, 8, 1, _sun_data(w, h, 8, 1, rng),
                         _u8(rng, 600)),
        "bits.ras": _sun(w, h, 1, 1, _sun_data(w, h, 1, 1, rng)),
        "float.spi": _save(Image.fromarray(rng.normal(
            120, 90, (h, w)).astype(np.float32), "F"), "SPIDER"),
        "i16.fits": _fits(16, w, h, _u8(rng, 2880)),
        "f32.fits": _fits(-32, w, h, rng.normal(100, 90, (h, w)).astype(
            ">f4").tobytes() + bytes(2880)),
        "gzip_tiles.fits": _fits_gzip(16, w, h, _u8(rng, 4 * w * h)),
        "rgba.im": _save(Image.fromarray(rgba), "IM"),
        "lut.im": _im("Greyscale image", w, h, _u8(rng, w * h), _u8(rng, 768)),
        "lstar12.im": _im("L*12 image", w, h, _u8(rng, 2 * w * h)),
        "ycc.im": _im("YCC image", w, h, _u8(rng, 3 * w * h)),
        "brun.fli": _fli_header(w, h) + _frame([
            _chunk(4, _fli_palette(rng)),
            _chunk(15, _brun(rgb[..., 0].copy(), rng))]),
        "lc_ss2.flc": _fli_header(w, h) + _frame([
            _chunk(11, _fli_palette(rng, True)),
            _chunk(16, rgb[..., 1].tobytes()), _chunk(12, _lc(w, h, rng)),
            _chunk(7, _ss2(w, h, rng))]),
        "blp1_jpeg.blp": _blp1_jpeg(w, h, 0, _save(img, "JPEG")),
        "blp1_pal.blp": _blp1_palette(w, h, 1, 5, _u8(rng, w * h), rng),
        "blp2_pal.blp": _save(img.quantize(20), "BLP"),
        "blp2_dxt1_alpha.blp": _blp2(w, h, 2, 1, 0, _blocks(rng, w, h, 8),
                                     rng),
        "blp2_dxt5.blp": _blp2(w, h, 2, 8, 7, _blocks(rng, w, h, 16), rng),
        "dxt1.ftc": _ftex(w, h, 0, _blocks(rng, w, h, 8)),
        "rgb.ftu": _ftex(w, h, 1, rgb.tobytes()),
        "rle_mask.icns": _icns([(b"is32", b"".join(_icns_rle(
            np.repeat(rgb[:16, :4], 4, 1)[..., c].tobytes() + bytes(64))
            for c in range(3))), (b"s8mk", _u8(rng, 256))]),
        "png.icns": _icns([(b"icp4", _save(Image.fromarray(
            rgba[:12, :16]).resize((16, 16)), "PNG"))]),
        "raw.iim": _iptc(w, h, 1, 0, 1, _u8(rng, w * h)),
        "band.iim": _iptc(w, h, 3, 1, 1, _u8(rng, w * h), 2),
        "float.pfm": _save(Image.fromarray(rng.normal(
            120, 90, (h, w)).astype(np.float32), "F"), "PPM"),
        "cmyk.pnm": b"P0CMYK %d %d 255\n" % (w, h) + _u8(rng, 4 * w * h),
        "rgba1000.pnm": b"PyRGBA %d %d 1000\n" % (w, h) + rng.integers(
            0, 1001, 4 * w * h).astype(">u2").tobytes(),
        "lab.tif": _tiff_file(w, h, [_u8(rng, 3 * w * h)], {
            258: (3, [8, 8, 8]), 259: (3, [1]), 262: (3, [8]),
            277: (3, [3]), 278: (4, [h])}),
        "lab.psd": _psd(9, 8, rng.integers(0, 256, (3, h, w)), 1)}
    return out


def write_fixtures():
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for old in FIXTURES.iterdir():
        old.unlink()
    for name, data in fixture_files().items():
        (FIXTURES / name).write_bytes(data)
        want = _pil(data)
        assert not isinstance(want, Exception), (name, want)
        Image.fromarray(want).save(FIXTURES / (name + ".png"))
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    print(f"{len(list(FIXTURES.iterdir()))} files, {total} bytes")


def test_committed_legacy_fixtures_equal_pil_and_their_pngs():
    """Each committed file decodes in the port as in PIL and equals the
    PNG of PIL's decode beside it (what chip_smoke.py checks without
    PIL); the set is the one fixture_files makes, under 120 KB."""
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if not p.name.endswith(".png"))
    assert names == sorted(fixture_files())
    total = 0
    for name in names:
        data = (FIXTURES / name).read_bytes()
        png = FIXTURES / (name + ".png")
        total += len(data) + png.stat().st_size
        got = tio.load_image(FIXTURES / name)
        np.testing.assert_array_equal(got, tio.load_image(png), err_msg=name)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)
    assert total < 120_000


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
    else:
        sys.exit("run with pytest, or with --write-fixtures")
