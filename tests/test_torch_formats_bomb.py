"""PIL's decompression-bomb guard in the port's load_image (assets/
modes.check_size, called by each reader on the size its header declares,
before anything is decoded) against the JAX package's load_image, which
reaches it through PIL's Image.open (PIL 12.1, MAX_IMAGE_PIXELS
89,478,485):

  - for each format PIL routes (PNG, BMP, GIF, TIFF, JPEG, WebP (VP8L,
    VP8 and VP8X), QOI, TGA, JPEG 2000, AVIF's ispe, PSD, SGI, PNM, PCX,
    Sun, XBM, FITS, GIMP brush, DIB, MSP, XPM, FTEX), a header
    just above 2 * 89,478,485 pixels raises DecompressionBombError in
    both packages, with PIL's message; a header just above 89,478,485
    warns in both, with PIL's text, and both then raise on the missing
    data; a header of 2 * 89,478,485 pixels, or the nearest size below it
    the format can state, is not refused;
  - .dds and .hdr, which the JAX package reads without PIL, are not
    guarded in either.

The files are headers with a few bytes of data: nothing large is
decoded or allocated."""

import struct
import warnings
import zlib
from pathlib import Path

import PIL.Image
import pytest

from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.assets import modes

FIXTURES = Path(__file__).resolve().parent / "data" / "formats_avif"
LIMIT = 89_478_485


def _png(w, h):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(16)))
            + chunk(b"IEND", b""))


def _bmp(w, h):
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0, 0)
    return b"BM" + struct.pack("<III", 54 + 16, 0, 54) + info + bytes(16)


def _gif(w, h):
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0)
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0)
            + b"\x08\x02\x00\x00;")


def _tiff(w, h):
    tags = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 1), (262, 3, 1),
            (273, 4, 8 + 2 + 12 * 9 + 4), (277, 3, 1), (278, 4, h),
            (279, 4, 16)]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII", t, typ, 1, v) if typ == 4 else
        struct.pack("<HHIHH", t, typ, 1, v, 0) for t, typ, v in tags)
    return b"II*\x00" + struct.pack("<I", 8) + ifd + bytes(4) + bytes(16)


def _jpeg(w, h):
    # three components sampled 2x1, 3x1, 1x1: libjpeg refuses the
    # fractional sampling when it decodes, after Image.open
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes((1, 0x21, 0, 2, 0x31, 0,
                                                    3, 0x11, 0))
    sos = bytes((3, 1, 0, 2, 0, 3, 0, 0, 63, 0))
    return (b"\xff\xd8" + b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
            + b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
            + bytes(8) + b"\xff\xd9")


def _riff(chunks):
    body = b"WEBP" + b"".join(
        tag + struct.pack("<I", len(b)) + b + b"\0" * (len(b) & 1)
        for tag, b in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8l_chunk(w, h):
    v = (w - 1) | (h - 1) << 14
    return b"\x2f" + struct.pack("<I", v) + bytes(11)


def _webp_vp8l(w, h):
    return _riff([(b"VP8L", _vp8l_chunk(w, h))])


def _webp_vp8(w, h):
    tag = (1 << 4) | (20 << 5)          # key frame, shown, partition size
    head = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a"
    return _riff([(b"VP8 ", head + struct.pack("<HH", w, h) + bytes(14))])


def _webp_vp8x(w, h):
    vp8x = bytes(4) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(
        3, "little")
    return _riff([(b"VP8X", vp8x), (b"VP8L", _vp8l_chunk(w, h))])


def _qoi(w, h):
    return b"qoif" + struct.pack(">IIBB", w, h, 3, 0) + bytes(8) + bytes(
        (0, 0, 0, 0, 0, 0, 0, 1))


def _tga(w, h):
    return struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24,
                       0x20) + bytes(16)


def _j2k(w, h):
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, 1) + bytes(
        (7, 1, 1))
    cod = bytes((0, 0, 0, 1, 0, 5, 4, 4, 0, 0))
    qcd = bytes((0x20,)) + bytes(16)
    return (b"\xff\x4f" + b"\xff\x51" + struct.pack(">H", 2 + len(siz)) + siz
            + b"\xff\x52" + struct.pack(">H", 2 + len(cod)) + cod
            + b"\xff\x5c" + struct.pack(">H", 2 + len(qcd)) + qcd
            + b"\xff\xd9")


def _avif(w, h):
    """A committed AVIF whose ispe states w x h and whose AV1 payload is
    zeros (no frame): libavif parses it, dav1d finds no frame."""
    from plainrenderer_tpu_torch.assets import isobmff
    data = bytearray((FIXTURES / "default_rgb.avif").read_bytes())
    f = isobmff.parse(bytes(data))
    item = f.items[f.primary]
    at = bytes(data).find(b"ispe")
    struct.pack_into(">II", data, at + 8, w, h)
    for off, length in item.extents:
        data[off:off + length] = bytes(length)
    return bytes(data)


def _psd(w, h):
    return (b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, h, w, 8, 3)
            + bytes(4) + bytes(4) + bytes(4) + struct.pack(">H", 0)
            + bytes(16))


def _sgi(w, h):
    head = struct.pack(">HBBHHHH", 474, 0, 1, 2, w, h, 1)
    return head + bytes(512 - len(head)) + bytes(16)


def _pnm(w, h):
    return b"P6\n%d %d\n255\n" % (w, h) + bytes(16)


def _pcx(w, h):
    head = bytearray(128)
    head[:4] = bytes((10, 5, 1, 8))
    struct.pack_into("<HHHH", head, 4, 0, 0, w - 1, h - 1)
    head[65] = 1
    struct.pack_into("<HH", head, 66, w, 1)
    # PIL seeks back 769 bytes for a version 5 palette
    return bytes(head) + bytes(16) + b"\x0c" + bytes(768)


def _sun(w, h):
    return struct.pack(">8I", 0x59A66A95, w, h, 8, w * h, 1, 0, 0) + bytes(16)


def _xbm(w, h):
    return (b"#define im_width %d\n#define im_height %d\n"
            b"static char im_bits[] = {\n0x00,0x01\n};\n" % (w, h))


def _fits(w, h):
    cards = [b"SIMPLE  =                    T",
             b"BITPIX  =                    8",
             b"NAXIS   =                    2",
             b"NAXIS1  = %20d" % w, b"NAXIS2  = %20d" % h, b"END"]
    return b"".join(c.ljust(80) for c in cards).ljust(2880) + bytes(16)


def _gbr(w, h):
    return struct.pack(">7I", 30, 2, w, h, 1, 0x47494D50, 0) + b"x\0" + bytes(
        16)


def _dib(w, h):
    return struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0,
                       0) + bytes(16)


def _msp(w, h):
    words = [0x6144, 0x4D6E, w, h] + [0] * 8
    check = 0
    for v in words:
        check ^= v
    return struct.pack("<16H", *words, check, 0, 0, 0) + bytes(16)


def _xpm(w, h):
    return (b'/* XPM */\nstatic char *x[] = {\n"%d %d 1 1",\n'
            b'"a c #000000",\n"a"\n};\n' % (w, h))


def _ftex(w, h):
    return (b"FTEX" + struct.pack("<i2i2i2i", 0x3FF, w, h, 0, 1, 0, 32)
            + struct.pack("<i", 16) + bytes(16))


def _dds_header(w, h):
    return (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0)
            + bytes(44) + struct.pack("<2I4s5I", 32, 0x41, b"", 32,
                                      0xFF0000, 0xFF00, 0xFF, 0xFF000000)
            + bytes(20) + bytes(16))


# format -> (header maker, suffix, (w, h) to raise, to warn, at the limit)
BIG = (13380, 13380)                 # 179,024,400
WARN = (9460, 9459)                  # 89,482,140
SIZES32 = ((1, 2 * LIMIT + 1), (10, LIMIT // 10 + 1), (10, 2 * LIMIT // 10))
SIZES16 = (BIG, WARN, (65535, 2 * LIMIT // 65535))
FORMATS = {
    "png": (_png, ".png", SIZES32),
    "bmp": (_bmp, ".bmp", SIZES32),
    "gif": (_gif, ".gif", SIZES16),
    "tiff": (_tiff, ".tif", SIZES32),
    "jpeg": (_jpeg, ".jpg", SIZES16),
    "webp_vp8l": (_webp_vp8l, ".webp", ((16384, 16384), WARN,
                                        (16384, 2 * LIMIT // 16384))),
    "webp_vp8": (_webp_vp8, ".webp", ((16383, 16383), WARN,
                                      (16383, 2 * LIMIT // 16383))),
    "webp_vp8x": (_webp_vp8x, ".webp", (BIG, WARN,
                                        (16384, 2 * LIMIT // 16384))),
    "qoi": (_qoi, ".qoi", SIZES32),
    "tga": (_tga, ".tga", SIZES16),
    "jpeg2000": (_j2k, ".j2k", SIZES32),
    "avif": (_avif, ".avif", (BIG, WARN, (13377, 13377))),
    "psd": (_psd, ".psd", SIZES32),
    "sgi": (_sgi, ".sgi", SIZES16),
    "pnm": (_pnm, ".ppm", SIZES32),
    "pcx": (_pcx, ".pcx", SIZES16),
    "sun": (_sun, ".ras", SIZES32),
    "xbm": (_xbm, ".xbm", SIZES32),
    "fits": (_fits, ".fits", SIZES32),
    "gbr": (_gbr, ".gbr", SIZES32),
    "dib": (_dib, ".dib", SIZES32),
    "msp": (_msp, ".msp", SIZES16),
    "xpm": (_xpm, ".xpm", SIZES32),
    "ftex": (_ftex, ".ftc", SIZES32),
}
# a DDS by its content (any suffix but .dds) goes through PIL: PIL pads a
# short DDS with zeros, so only its refusal is cheap to hold
REFUSED_ONLY = {"dds_content": (_dds_header, ".bin", SIZES32)}


def _load(load, path):
    """(result or exception, warnings' messages) of one load."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            out = load(path)
        except Exception as e:  # noqa: BLE001 - any refusal
            out = e
    return out, [(w.category.__name__, str(w.message)) for w in seen
                 if "decompression bomb" in str(w.message)]


def _both(tmp_path, name, case):
    build, suffix, sizes = {**FORMATS, **REFUSED_ONLY}[name]
    w, h = sizes[case]
    p = tmp_path / f"case{suffix}"
    p.write_bytes(build(w, h))
    return _load(jio.load_image, p), _load(tio.load_image, p), w * h


@pytest.mark.parametrize("name", sorted({**FORMATS, **REFUSED_ONLY}))
def test_above_twice_the_limit_raises(tmp_path, name):
    (want, _), (got, _), n = _both(tmp_path, name, 0)
    assert n > 2 * LIMIT
    assert isinstance(want, PIL.Image.DecompressionBombError), want
    assert isinstance(got, modes.DecompressionBombError), got
    assert isinstance(got, ValueError)
    assert str(got) == str(want)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_above_the_limit_warns_then_both_raise(tmp_path, name):
    (want, jw), (got, tw), n = _both(tmp_path, name, 1)
    assert LIMIT < n <= 2 * LIMIT
    # PIL's GBR plugin checks once more than Image.open does
    assert jw and jw == tw and {c for c, _ in jw} == {
        "DecompressionBombWarning"}, (jw, tw)
    assert issubclass(modes.DecompressionBombWarning, RuntimeWarning)
    assert isinstance(want, Exception) and isinstance(got, ValueError), (
        want, got)
    assert not isinstance(want, PIL.Image.DecompressionBombError)
    assert not isinstance(got, modes.DecompressionBombError)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_at_twice_the_limit_is_not_refused(tmp_path, name):
    (want, jw), (got, tw), n = _both(tmp_path, name, 2)
    assert 2 * LIMIT - 65535 < n <= 2 * LIMIT
    assert jw and jw == tw
    assert not isinstance(want, PIL.Image.DecompressionBombError), want
    assert not isinstance(got, modes.DecompressionBombError), got
    assert isinstance(want, Exception) == isinstance(got, Exception)


def _dds_rgba8(w, h):
    """The DX10 header of an RGBA8 texture, as the .dds path reads it."""
    head = bytearray(124)
    struct.pack_into("<7I", head, 0, 124, 0x1007, h, w, 0, 1, 1)
    head[80:84] = b"DX10"
    return (b"DDS " + bytes(head) + struct.pack("<5I", 28, 3, 0, 1, 0)
            + bytes(16))


def _hdr(w, h):
    return (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)
            + bytes(16))


@pytest.mark.parametrize("suffix,build", [(".dds", _dds_rgba8),
                                          (".hdr", _hdr)])
def test_dds_and_hdr_are_not_guarded(tmp_path, suffix, build):
    """Read without PIL in both packages: a header above twice the limit
    raises neither the bomb error nor its warning, only the truncation."""
    p = tmp_path / f"case{suffix}"
    p.write_bytes(build(*BIG))
    (want, jw), (got, tw) = _load(jio.load_image, p), _load(tio.load_image, p)
    assert jw == tw == []
    assert isinstance(want, Exception) and isinstance(got, ValueError)
    assert not isinstance(want, PIL.Image.DecompressionBombError)
    assert not isinstance(got, modes.DecompressionBombError)


def test_limits_are_pils():
    assert modes.MAX_IMAGE_PIXELS == PIL.Image.MAX_IMAGE_PIXELS == LIMIT
    assert issubclass(modes.DecompressionBombError, ValueError)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        modes.check_size(LIMIT, 1)
        modes.check_size(0, LIMIT)
    assert seen == []
    with pytest.raises(modes.DecompressionBombError, match="178956971"):
        modes.check_size(2 * LIMIT + 1, 0)
    assert 2 * LIMIT == 178_956_970
