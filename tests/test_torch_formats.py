"""The port's image readers and writers (assets/bmp.py, tga.py, pnm.py,
gif.py with lzw.py, tiff.py, webp.py with vp8l.py and vp8.py, jpeg.py's
CMYK / YCCK and block smoothing, image_io's dispatch and save_image)
against PIL, which the JAX package's load_image and save_image use:

  - every reader equals ``np.asarray(Image.open(p).convert("RGBA"))`` bit
    for bit on files PIL writes here and on files this test builds
    itself where PIL writes no such file (BMP RLE and bitfields, TGA
    colour maps, plain PNM, GIF local tables and offsets, TIFF tiles,
    planes, byte orders and fill orders, WebP raw alpha with each filter,
    an animation's offset frame, VP8 frames re-encoded with the simple
    loop filter, sharpness and mode deltas); where PIL refuses a file the
    port raises ValueError naming the feature;
  - the committed fixtures in tests/data/formats (each beside PIL's
    decode of it as PNG, which chip_smoke.py checks on the card's
    machine, which has no PIL);
  - save_image: each suffix and mode decodes in PIL as PIL's own save of
    the same array does; other suffixes raise and write nothing; the
    PNG bytes the app streams are unchanged;
  - the slice against the JAX package: _load_texture_images and
    _compute_mean_albedo on BMP, TGA, PNM, GIF, TIFF and WebP maps, and a
    courtyard glTF with WebP and TGA base colours imported to the same
    .plain bytes by both packages.

``python tests/test_torch_formats.py --write-fixtures`` regenerates
tests/data/formats; ``python tests/test_torch_formats.py`` prints each
fixture's decode time on the host."""

import hashlib
import io
import json
import shutil
import struct
import sys
import time
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from plainrenderer_tpu.assets import gltf_import as jgltf
from plainrenderer_tpu.assets import plain_format as jplain
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu_torch.assets import gltf_import as tgltf
from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.assets import plain_format as tplain
from plainrenderer_tpu_torch.assets import vp8
from plainrenderer_tpu_torch.render import scenebuild as tsb

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
FIXTURES = Path(__file__).resolve().parent / "data" / "formats"


# ------------------------------ helpers ------------------------------

def _pil(data: bytes):
    """PIL's decode, or the exception it raises."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA"))
    except Exception as e:  # noqa: BLE001 - any refusal of PIL's
        return e


def _check(data: bytes, suffix: str):
    """PIL reads the file, and the port's decode equals PIL's."""
    want = _pil(data)
    assert not isinstance(want, Exception), want
    got = tio.decode_image(data, "case", suffix)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _refused(data: bytes, suffix: str, name: str, pil_reads: bool):
    """The port raises ValueError naming `name`. PIL refuses the file too
    (pil_reads False), or reads it: a feature the port does not read yet,
    listed in ROADMAP.md (pil_reads True)."""
    assert isinstance(_pil(data), Exception) != pil_reads
    with pytest.raises(ValueError, match=name):
        tio.decode_image(data, "case", suffix)


def _save(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _picture(w, h, c=3, seed=0):
    """Gradients with noise: smooth enough for the lossy codecs to keep
    detail, noisy enough that every block codes something."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    chans = [x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
             (x + 2 * y) * 5.0 % 256, 255.0 - (x * y) % 200]
    a = np.stack(chans[:c], -1) + rng.normal(0, 12, (h, w, c))
    return np.clip(a, 0, 255).astype(np.uint8)


def _images(w, h, seed=0):
    """PIL images of every mode the writers take."""
    rgb = _picture(w, h, 3, seed)
    rgba = _picture(w, h, 4, seed)
    rng = np.random.default_rng(seed)
    return {
        "1": Image.fromarray(rgb[..., 0]).convert("1"),
        "L": Image.fromarray(rgb[..., 1]),
        "LA": Image.fromarray(rgba[..., :2].copy(), "LA"),
        "P": Image.fromarray(rgb).quantize(23),
        "RGB": Image.fromarray(rgb),
        "RGBA": Image.fromarray(rgba),
        "I;16": Image.frombytes("I;16", (w, h), rng.integers(
            0, 900, (h, w)).astype("<u2").tobytes()),
    }


SIZES = ((1, 1), (7, 5), (33, 17))


# -------------------------------- BMP --------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_bmp_written_by_pil(size):
    for mode, im in _images(*size).items():
        if mode in ("1", "L", "P", "RGB", "RGBA"):
            _check(_save(im, "BMP"), ".bmp")


def _bmp(w, h, bits, rows, hsize=40, compression=0, masks=None,
         palette=b"", top_down=False, colors=0, offset=None):
    """A BMP file around `rows` (the pixel data exactly as stored)."""
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h,
                           1, bits, compression, len(rows), 2835, 2835,
                           colors, 0)
        if hsize >= 52:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            head += struct.pack("<4I", *m[:4]) if hsize >= 56 else \
                struct.pack("<3I", *m[:3])
        head = head.ljust(hsize, b"\0")
    extra = struct.pack("<3I", *masks[:3]) if (
        masks is not None and hsize == 40) else b""
    off = offset if offset is not None else 14 + hsize + len(extra) + len(
        palette)
    body = head + extra + palette
    return (b"BM" + struct.pack("<III", 14 + len(body) + len(rows), 0, off)
            + body + rows)


def _rows(a, bits, bottom_up=True):
    """Pixel rows packed at `bits` (indices or 16-bit values, or
    pre-ordered bytes for 24 / 32), each padded to 4 bytes."""
    h = a.shape[0]
    out = []
    for y in range(h):
        r = a[y]
        if bits < 8:
            per = 8 // bits
            v = np.zeros(-(-len(r) // per) * per, np.uint8)
            v[:len(r)] = r
            v = v.reshape(-1, per)
            row = sum(v[:, k].astype(np.uint8) << (8 - bits * (k + 1))
                      for k in range(per)).astype(np.uint8).tobytes()
        elif bits == 16:
            row = r.astype("<u2").tobytes()
        else:
            row = np.ascontiguousarray(r).astype(np.uint8).tobytes()
        out.append(row + b"\0" * (-len(row) % 4))
    return b"".join(out[::-1] if bottom_up else out)


def _bgrx(pal):
    return b"".join(bytes((b, g, r, 0)) for r, g, b in pal)


@pytest.mark.parametrize("case", [
    "pal1", "pal4", "pal8_short", "grey8", "core_pal8", "rgb555", "rgb565",
    "rgb555_bitfields", "rgb24_topdown", "bgrx32", "v4_rgba32", "v5_abgr32",
    "v5_rgba32_masks", "v5_bgra_noalpha", "offset_skips_palette"])
def test_bmp_layouts_built_here(case):
    rng = np.random.default_rng(len(case))
    w, h = 13, 6
    pal = [tuple(rng.integers(0, 256, 3)) for _ in range(256)]
    idx = rng.integers(0, 256, (h, w))
    px32 = rng.integers(0, 256, (h, w, 4))
    v16 = rng.integers(0, 65536, (h, w))
    if case == "pal1":
        data = _bmp(w, h, 1, _rows(idx % 2, 1), palette=_bgrx(pal[:2]))
    elif case == "pal4":
        data = _bmp(w, h, 4, _rows(idx % 16, 4), palette=_bgrx(pal[:16]),
                    colors=16)
    elif case == "pal8_short":  # 40 colours, indices past them
        data = _bmp(w, h, 8, _rows(idx, 8), palette=_bgrx(pal[:40]),
                    colors=40)
    elif case == "grey8":
        data = _bmp(w, h, 8, _rows(idx, 8),
                    palette=_bgrx([(i, i, i) for i in range(256)]))
    elif case == "core_pal8":
        data = _bmp(w, h, 8, _rows(idx, 8), hsize=12,
                    palette=b"".join(bytes((b, g, r)) for r, g, b in pal))
    elif case == "rgb555":
        data = _bmp(w, h, 16, _rows(v16, 16))
    elif case == "rgb565":
        data = _bmp(w, h, 16, _rows(v16, 16), compression=3,
                    masks=(0xF800, 0x7E0, 0x1F))
    elif case == "rgb555_bitfields":
        data = _bmp(w, h, 16, _rows(v16, 16), hsize=56, compression=3,
                    masks=(0x7C00, 0x3E0, 0x1F, 0))
    elif case == "rgb24_topdown":
        data = _bmp(w, h, 24, _rows(px32[..., :3], 24, False),
                    top_down=True)
    elif case == "bgrx32":
        data = _bmp(w, h, 32, _rows(px32, 32))
    elif case == "v4_rgba32":
        data = _bmp(w, h, 32, _rows(px32, 32), hsize=108, compression=3,
                    masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    elif case == "v5_abgr32":
        data = _bmp(w, h, 32, _rows(px32, 32), hsize=124, compression=3,
                    masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF))
    elif case == "v5_rgba32_masks":
        data = _bmp(w, h, 32, _rows(px32, 32, False), hsize=124,
                    compression=3, top_down=True,
                    masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    elif case == "v5_bgra_noalpha":
        data = _bmp(w, h, 32, _rows(px32, 32), hsize=124, compression=3,
                    masks=(0xFF0000, 0xFF00, 0xFF, 0))
    else:  # offset == 14 + header size: PIL skips the palette's bytes
        data = _bmp(w, h, 8, _rows(idx, 8), palette=_bgrx(pal),
                    offset=14 + 40)
    _check(data, ".bmp")


def _rle_stream(h, w, n, rle4, rng, delta=False):
    """A random RLE8 / RLE4 stream for an image of h rows of w pixels
    (indices below n): encoded runs, absolute runs (odd ones too, which
    PIL reads short in RLE4), end-of-line and end-of-bitmap; with
    `delta`, one delta escape as PIL reads it (two bytes it skips, then
    right and up)."""
    out = bytearray()
    for y in range(h):
        x = 0
        if delta and y == 1:
            out += bytes((0, 2, 9, 9, 2, 0))  # PIL: zero-fill 2 pixels
            x = 2
        while x < w:
            k = min(int(rng.integers(1, 7)), w - x)
            if k < 3 or rng.random() < 0.5:
                v = int(rng.integers(0, 256 if rle4 else n))
                if rle4:
                    v = (v >> 4) % n << 4 | (v & 15) % n
                out += bytes((k, v))
            else:
                if rle4 and y == h - 1:
                    k -= k % 2  # an odd run there would leave PIL short
                vals = rng.integers(0, n, k)
                if rle4:
                    packed = bytes(int(vals[i]) << 4 | int(vals[i + 1])
                                   for i in range(0, k - 1, 2))
                else:
                    packed = bytes(int(v) for v in vals)
                out += bytes((0, k)) + packed
                if len(out) % 2:  # PIL's word alignment
                    out += b"\0"
            x += k
        out += bytes((0, 0)) if y < h - 1 else bytes((0, 1))
    return bytes(out)


@pytest.mark.parametrize("rle4", [False, True])
@pytest.mark.parametrize("delta", [False, True])
def test_bmp_rle_built_here(rle4, delta):
    rng = np.random.default_rng(7 + rle4 + 2 * delta)
    w, h = 14, 5
    n = 16 if rle4 else 256
    pal = _bgrx([tuple(rng.integers(0, 256, 3)) for _ in range(n)])
    stream = _rle_stream(h, w, n, rle4, rng, delta)
    data = _bmp(w, h, 4 if rle4 else 8, stream, compression=2 if rle4
                else 1, palette=pal, colors=n)
    _check(data, ".bmp")
    # an end of bitmap before the image is full: PIL refuses it
    short = _bmp(w, h, 4 if rle4 else 8, bytes((2, 17, 0, 1)),
                 compression=2 if rle4 else 1, palette=pal, colors=n)
    _refused(short, ".bmp", "not enough image data", False)


def test_bmp_refusals_name_the_feature():
    w, h = 4, 2
    rows = _rows(np.zeros((h, w, 4), np.uint8), 32)
    for comp, name in ((4, "BI_JPEG"), (5, "BI_PNG"),
                       (6, "BI_ALPHABITFIELDS")):
        _refused(_bmp(w, h, 32, rows, compression=comp), ".bmp", name,
                 False)
    _refused(_bmp(w, h, 32, rows, compression=3, hsize=124,
                  masks=(0xF, 0xF0, 0xF00, 0)), ".bmp", "bitfields", False)
    _refused(_bmp(w, h, 2, rows), ".bmp", "depth 2", False)
    _refused(_bmp(w, h, 24, rows, hsize=20), ".bmp", "header size", False)


# -------------------------------- TGA --------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_tga_written_by_pil(size):
    for mode, im in _images(*size).items():
        if mode == "I;16":
            continue
        for kw in ({}, {"compression": "tga_rle"}, {"orientation": 1},
                   {"compression": "tga_rle", "orientation": 1}):
            data = _save(im, "TGA", **kw)
            if mode == "1" and kw.get("compression"):
                _refused(data, ".tga", "run-length 1-bit", False)
            else:
                _check(data, ".tga")


def _tga(w, h, itype, depth, pixels, flags=0x20, cmap=None, cmap_first=0,
         cmap_depth=24, id_field=b""):
    maptype = 1 if cmap is not None else 0
    n = (len(cmap) * 8 // cmap_depth) if cmap is not None else 0
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), maptype, itype,
                       cmap_first, n, cmap_depth if maptype else 0, 0, 0, w,
                       h, depth, flags)
    return head + id_field + (cmap or b"") + pixels


@pytest.mark.parametrize("case", [
    "rgb16", "cmap16_first", "cmap24_rle", "grey1", "la16_rle",
    "flip_x", "flip_both_rle32", "id_field"])
def test_tga_layouts_built_here(case):
    rng = np.random.default_rng(len(case) + 3)
    w, h = 6, 4
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if case == "rgb16":
        data = _tga(w, h, 2, 16, rng.integers(0, 65536, w * h).astype(
            "<u2").tobytes())
    elif case == "cmap16_first":
        cmap = rng.integers(0, 65536, 9).astype("<u2").tobytes()
        data = _tga(w, h, 1, 8, rng.integers(0, 12, w * h).astype(
            np.uint8).tobytes(), cmap=cmap, cmap_first=3, cmap_depth=16)
    elif case == "cmap24_rle":
        cmap = rng.integers(0, 256, 30).astype(np.uint8).tobytes()
        rows = b"".join(bytes((0x82, 3, 0x02, 1, 4, 5)) for _ in range(h))
        data = _tga(w, h, 9, 8, rows, cmap=cmap)
    elif case == "grey1":
        data = _tga(11, h, 3, 1, rng.integers(0, 256, 2 * h).astype(
            np.uint8).tobytes())
    elif case == "la16_rle":
        rows = b"".join(bytes((0x82, 9, 200, 2, 1, 2, 3, 4, 5, 6))
                        for _ in range(h))
        data = _tga(w, h, 11, 16, rows)
    elif case == "flip_x":
        data = _tga(w, h, 2, 24, px[..., :3].tobytes(), flags=0x30)
    elif case == "flip_both_rle32":
        rows = b"".join(bytes((0x85,)) + px[y, 0].tobytes()
                        for y in range(h))
        data = _tga(w, h, 10, 32, rows, flags=0x18)
    else:
        data = _tga(w, h, 2, 24, px[..., :3].tobytes(), id_field=b"plain!")
    _check(data, ".tga")


def test_tga_refusals_name_the_feature():
    w, h = 3, 2
    _refused(_tga(w, h, 2, 15, bytes(12)), ".tga", "not a TGA", False)
    _refused(_tga(w, h, 1, 8, bytes(6), cmap=bytes(8), cmap_depth=32),
             ".tga", "colour map of 32", False)
    _refused(_tga(w, h, 2, 24, bytes(18), cmap=bytes(6)), ".tga",
             "colour map on a type 2", False)
    _refused(_tga(w, h, 10, 24, bytes((0x85, 1, 2, 3))), ".tga",
             "crosses a row", False)
    _refused(_tga(w, h, 10, 24, bytes((0x82, 1, 2, 3))), ".tga",
             "truncated", False)
    # a TGA header under another suffix: the port does not guess (PIL
    # tries TGA after every other format, whatever the name)
    with pytest.raises(ValueError, match="not read by the port"):
        tio.decode_image(_tga(w, h, 2, 24, bytes(18)), "x", ".bin")


# -------------------------------- PNM --------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_pnm_written_by_pil(size):
    for mode, im in _images(*size).items():
        if mode in ("1", "L", "RGB", "RGBA", "I;16"):
            _check(_save(im, "PPM"), ".ppm")


@pytest.mark.parametrize("magic,maxval", [("P1", 1)] + [
    (m, v) for m in ("P2", "P3", "P5", "P6")
    for v in (1, 15, 255, 1000, 65535)])
def test_pnm_maxvals_built_here(magic, maxval):
    rng = np.random.default_rng(maxval)
    w, h = 5, 3
    bands = 3 if magic in ("P3", "P6") else 1
    vals = rng.integers(0, maxval + 1, (h, w * bands))
    if magic == "P1":
        body = "\n".join(" ".join(str(int(v) & 1) for v in r) for r in vals)
        data = f"P1\n# a comment\n{w} {h}\n{body}\n".encode()
    elif magic in ("P2", "P3"):
        body = "\n".join(" ".join(str(int(v)) for v in r) for r in vals)
        data = f"{magic}\n{w} # width\n{h}\n{maxval}\n{body}\n".encode()
    else:
        dt = np.uint8 if maxval < 256 else ">u2"
        data = f"{magic}\n{w} {h}\n{maxval}\n".encode() + vals.astype(
            dt).tobytes()
    _check(data, ".pnm")


def test_pnm_refusals_name_the_feature():
    _refused(b"Pf\n2 2\n0.0\n" + bytes(16), ".pfm", "scale", False)
    _refused(b"P5\n2 2\n0\n" + bytes(4), ".pgm", "maxval", False)
    _refused(b"P6\n2 2\n255\n" + bytes(5), ".ppm", "truncated", False)


# -------------------------------- GIF --------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_gif_written_by_pil(size):
    for mode, im in _images(*size).items():
        if mode in ("L", "P", "RGB", "1"):
            for kw in ({}, {"interlace": 1}, {"transparency": 3}):
                _check(_save(im, "GIF", **kw), ".gif")


def _lzw_gif(idx, min_size):
    """GIF LZW of `idx` in literal codes, a clear code before the table
    would widen the codes (a valid stream any decoder reads)."""
    clear = 1 << min_size
    size = min_size + 1
    bits, nbits, out = 0, 0, bytearray()

    def put(code):
        nonlocal bits, nbits
        bits |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(bits & 255)
            bits >>= 8
            nbits -= 8
    table = clear + 2
    put(clear)
    first = True
    for v in idx:
        if table + 1 >= 1 << size:
            put(clear)
            table, first = clear + 2, True
        put(int(v))
        if not first:
            table += 1
        first = False
    put(clear + 1)
    if nbits:
        out.append(bits & 255)
    blocks = b"".join(bytes((len(out[i:i + 255]),)) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return bytes((min_size,)) + blocks + b"\0"


def _gif(w, h, frame, x0=0, y0=0, gpal=None, lpal=None, transparency=None,
         interlace=False, min_size=None):
    fh, fw = frame.shape
    pal_bits = lambda p: (len(p) // 3).bit_length() - 1  # noqa: E731
    flags = (0x80 | (pal_bits(gpal) - 1)) if gpal else 0
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, flags, 0, 0) + (gpal or b"")
    if transparency is not None:
        out += b"!\xf9\x04" + bytes((1, 0, 0, transparency, 0))
    out += b"!\xfe\x05hello\x00"  # a comment extension
    lflags = (0x80 | (pal_bits(lpal) - 1)) if lpal else 0
    lflags |= 0x40 if interlace else 0
    out += b"," + struct.pack("<HHHHB", x0, y0, fw, fh, lflags) + (
        lpal or b"")
    rows = frame
    if interlace:
        order = (list(range(0, fh, 8)) + list(range(4, fh, 8))
                 + list(range(2, fh, 4)) + list(range(1, fh, 2)))
        rows = frame[order]
    out += _lzw_gif(rows.ravel(), min_size or 8)
    return out + b";"


@pytest.mark.parametrize("case", [
    "local_palette", "offset_frame_transparent", "grows_the_screen",
    "grey_ramp_is_L", "no_palette_is_L", "interlaced_local", "small_codes",
    "indices_past_table"])
def test_gif_layouts_built_here(case):
    rng = np.random.default_rng(len(case))
    pal4 = rng.integers(0, 256, 48).astype(np.uint8).tobytes()  # 16
    pal2 = rng.integers(0, 256, 12).astype(np.uint8).tobytes()  # 4
    frame = rng.integers(0, 16, (9, 11)).astype(np.uint8)
    if case == "local_palette":
        data = _gif(11, 9, frame, gpal=pal2, lpal=pal4)
    elif case == "offset_frame_transparent":
        data = _gif(20, 15, frame, 3, 2, gpal=pal4, transparency=5)
    elif case == "grows_the_screen":
        data = _gif(8, 8, frame, 4, 1, gpal=pal4)
    elif case == "grey_ramp_is_L":
        ramp = bytes(v for i in range(16) for v in (i, i, i))
        data = _gif(11, 9, frame, gpal=ramp, transparency=2)
    elif case == "no_palette_is_L":
        data = _gif(11, 9, frame, transparency=7)
    elif case == "interlaced_local":
        data = _gif(11, 9, frame, lpal=pal4, interlace=True)
    elif case == "small_codes":
        data = _gif(11, 9, frame % 4, gpal=pal2, min_size=2)
    else:
        data = _gif(11, 9, frame, gpal=pal2, min_size=4)
    _check(data, ".gif")


def test_gif_truncated_data_raises():
    rng = np.random.default_rng(0)
    data = _gif(11, 9, rng.integers(0, 16, (9, 11)).astype(np.uint8),
                gpal=rng.integers(0, 256, 48).astype(np.uint8).tobytes())
    at = data.index(b",") + 10  # the image data after the descriptor
    short = data[:at] + _lzw_gif(np.zeros(50, np.uint8), 8) + b";"
    _refused(short, ".gif", "truncated", False)


# -------------------------------- TIFF -------------------------------

TIFF_PIL = [
    (mode, kw) for mode in ("1", "L", "LA", "P", "RGB", "RGBA", "I;16")
    for kw in ({}, {"compression": "tiff_lzw"},
               {"compression": "tiff_deflate"},
               {"compression": "tiff_adobe_deflate"},
               {"compression": "packbits"})]


@pytest.mark.parametrize("mode,kw", TIFF_PIL)
def test_tiff_written_by_pil(mode, kw):
    for size in ((1, 1), (33, 17)):
        _check(_save(_images(*size)[mode], "TIFF", **kw), ".tif")


@pytest.mark.parametrize("kw", [
    {"compression": "tiff_lzw", "tiffinfo": {317: 2}},
    {"compression": "tiff_adobe_deflate", "tiffinfo": {317: 2}},
    {"compression": "tiff_lzw", "tiled": True, "tile_width": 16,
     "tile_length": 16},
    {"compression": "raw", "tiled": True, "tile_width": 16,
     "tile_length": 16}])
def test_tiff_predictor_and_tiles_written_by_pil(kw):
    for mode in ("L", "RGB", "RGBA", "I;16"):
        _check(_save(_images(37, 21, 5)[mode], "TIFF", **kw), ".tif")


def _packbits(raw: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(raw), 100):
        chunk = raw[i:i + 100]
        if len(set(chunk)) == 1 and len(chunk) > 1:
            out += bytes((257 - len(chunk),)) + chunk[:1]
        else:
            out += bytes((len(chunk) - 1,)) + chunk
    return bytes(out)


def _tiff(samples, bits, photometric, bo="<", compression=1, predictor=1,
          planar=1, tile=None, rows_per_strip=None, extra=(), colormap=None,
          fill=1, sample_format=None, orientation=None):
    """A single-page TIFF of (H, W, S) integer samples."""
    h, w, spp = samples.shape
    if tile:
        cw, ch = tile
    else:
        cw, ch = w, rows_per_strip or h
    across, down = -(-w // cw), -(-h // ch)
    planes = spp if planar == 2 else 1
    per = spp // planes
    chunks = []
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                rows = ch if tile else min(ch, h - y0)
                block = np.zeros((rows, cw, per), np.int64)
                part = samples[y0:y0 + rows, x0:x0 + cw, p:p + per]
                block[:part.shape[0], :part.shape[1]] = part
                if predictor == 2:
                    block[:, 1:] = np.diff(block, axis=1)
                    block %= 1 << bits
                flat = block.reshape(rows, cw * per)
                if bits in (8, 16, 32):
                    dt = {8: np.uint8, 16: bo + "u2", 32: bo + "u4"}[bits]
                    raw = flat.astype(dt).tobytes()
                else:
                    bits_ = ((flat[..., None] >> np.arange(bits - 1, -1, -1))
                             & 1).reshape(rows, -1).astype(np.uint8)
                    raw = np.packbits(bits_, axis=1).tobytes()
                if compression == 8:
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    raw = _packbits(raw)
                if fill == 2:
                    raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                chunks.append(raw)
    data_at = 8
    blob = b"".join(chunks)
    offsets, pos = [], data_at
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags.update({322: (3, [cw]), 323: (3, [ch]), 324: (4, offsets),
                     325: (4, [len(c) for c in chunks])})
    else:
        tags.update({273: (4, offsets), 278: (4, [ch]),
                     279: (4, [len(c) for c in chunks])})
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    if fill != 1:
        tags[266] = (3, [fill])
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if orientation is not None:
        tags[274] = (3, [orientation])
    ifd_at = data_at + len(blob)
    ifd_at += ifd_at & 1
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, extras = b"", b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        fmt = "H" if typ == 3 else "I"
        packed = struct.pack(bo + fmt * len(vals), *vals)
        if len(packed) <= 4:
            entries += struct.pack(bo + "HHI", tag, typ, len(vals)) + \
                packed.ljust(4, b"\0")
        else:
            entries += struct.pack(bo + "HHII", tag, typ, len(vals),
                                   extra_at + len(extras))
            extras += packed
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "I",
                                                               ifd_at)
    body = blob + b"\0" * (ifd_at - data_at - len(blob))
    return head + body + struct.pack(bo + "H", len(tags)) + entries + \
        b"\0\0\0\0" + extras


TIFF_BUILT = [
    "mm_rgb16", "mm_grey8_strips", "whiteiszero_1", "whiteiszero_4",
    "whiteiszero_8", "grey2", "pal4_packbits", "pal2_deflate",
    "pal8_alpha", "rgbx_extra0", "rgba_assoc", "rgba16_assoc",
    "rgba_unassoc_planar", "rgb_planar_deflate_pred", "la_planar_deflate",
    "pa_planar_packbits", "rgba_assoc_planar_deflate",
    "rgb_tiles_deflate_mm", "grey16_pred_deflate", "fill2_grey8",
    "fill2_bilevel_packbits", "int32", "int16_signed", "rgb_4th_sample",
    "rgba16_unassoc"]


@pytest.mark.parametrize("case", TIFF_BUILT)
def test_tiff_layouts_built_here(case):
    rng = np.random.default_rng(len(case) * 7 + 1)
    w, h = 19, 11

    def s(n, hi):
        return rng.integers(0, hi, (h, w, n))
    cmap = lambda n: rng.integers(0, 65536, 3 * n)  # noqa: E731
    table = {
        "mm_rgb16": lambda: _tiff(s(3, 65536), 16, 2, ">"),
        "mm_grey8_strips": lambda: _tiff(s(1, 256), 8, 1, ">",
                                         rows_per_strip=3),
        "whiteiszero_1": lambda: _tiff(s(1, 2), 1, 0, rows_per_strip=4),
        "whiteiszero_4": lambda: _tiff(s(1, 16), 4, 0),
        "whiteiszero_8": lambda: _tiff(s(1, 256), 8, 0, compression=8),
        "grey2": lambda: _tiff(s(1, 4), 2, 1),
        "pal4_packbits": lambda: _tiff(s(1, 16), 4, 3, compression=32773,
                                       colormap=cmap(16)),
        "pal2_deflate": lambda: _tiff(s(1, 4), 2, 3, compression=8,
                                      colormap=cmap(4)),
        "pal8_alpha": lambda: _tiff(s(2, 256), 8, 3, extra=(2,),
                                    colormap=cmap(256)),
        "rgbx_extra0": lambda: _tiff(s(4, 256), 8, 2, extra=(0,)),
        "rgba_assoc": lambda: _tiff(s(4, 256), 8, 2, extra=(1,),
                                    compression=8),
        "rgba16_assoc": lambda: _tiff(s(4, 65536), 16, 2, ">", extra=(1,)),
        "rgba_unassoc_planar": lambda: _tiff(s(4, 256), 8, 2, extra=(2,),
                                             planar=2, rows_per_strip=4),
        "rgb_planar_deflate_pred": lambda: _tiff(
            s(3, 256), 8, 2, compression=8, predictor=2, planar=2),
        "la_planar_deflate": lambda: _tiff(s(2, 256), 8, 1, extra=(2,),
                                           planar=2, compression=8),
        "pa_planar_packbits": lambda: _tiff(s(2, 256), 8, 3, extra=(2,),
                                            planar=2, compression=32773,
                                            colormap=cmap(256)),
        "rgba_assoc_planar_deflate": lambda: _tiff(
            s(4, 256), 8, 2, extra=(1,), planar=2, compression=8),
        "rgb_tiles_deflate_mm": lambda: _tiff(s(3, 256), 8, 2, ">",
                                              compression=8, tile=(16, 16)),
        "grey16_pred_deflate": lambda: _tiff(s(1, 700), 16, 1,
                                             compression=8, predictor=2),
        "fill2_grey8": lambda: _tiff(s(1, 256), 8, 1, fill=2),
        "fill2_bilevel_packbits": lambda: _tiff(s(1, 2), 1, 0, fill=2,
                                                compression=32773),
        "int32": lambda: _tiff(s(1, 600), 32, 1),
        "int16_signed": lambda: _tiff(s(1, 65536), 16, 1,
                                      sample_format=2),
        "rgb_4th_sample": lambda: _tiff(s(4, 256), 8, 2),
        "rgba16_unassoc": lambda: _tiff(s(4, 65536), 16, 2, extra=(2,)),
    }
    _check(table[case](), ".tif")


def test_tiff_refusals_name_the_feature():
    """What PIL refuses too, by name; the CCITT Group 4 and 12-bit files
    PIL reads are read now, equal to PIL's decode (more in
    tests/test_torch_formats_codecs.py)."""
    rng = np.random.default_rng(0)
    img = Image.fromarray(_picture(16, 8))
    # raw samples as old-style JPEG or ZSTD data: PIL refuses them as bad
    # data, the port names the codec
    _refused(_tiff(rng.integers(0, 256, (4, 4, 1)), 8, 1, compression=6),
             ".tif", "old-style JPEG", False)
    _check(_save(img.convert("1"), "TIFF", compression="group4"), ".tif")
    _refused(_tiff(rng.integers(0, 256, (4, 4, 3)), 8, 9), ".tif", "ICCLab",
             False)
    _refused(_tiff(rng.integers(0, 65536, (4, 4, 1)), 16, 1,
                   sample_format=3), ".tif", "SampleFormat", False)
    _check(_tiff(rng.integers(0, 4096, (4, 4, 1)), 12, 1), ".tif")
    _refused(_tiff(rng.integers(0, 256, (4, 4, 1)), 8, 1, compression=50000),
             ".tif", "ZSTD", False)
    _refused(_tiff(rng.integers(0, 256, (4, 4, 2)), 8, 1, extra=(2,),
                   planar=2), ".tif", "planar", False)
    _refused(_tiff(rng.integers(0, 256, (4, 4, 4)), 8, 2, extra=(0,),
                   planar=2, compression=8), ".tif", "planar", False)
    with pytest.raises(ValueError, match="BigTIFF"):
        tio.decode_image(b"II+\x00" + bytes(20), "x", ".tif")


# -------------------------------- WebP -------------------------------

@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("size", [(1, 1), (5, 3), (37, 23), (128, 96)])
def test_webp_written_by_pil(lossless, size):
    w, h = size
    for c in (3, 4):
        im = Image.fromarray(_picture(w, h, c, w))
        opts = ({"quality": 100, "method": 6}, {"quality": 0, "method": 0}) \
            if lossless else ({"quality": 90}, {"quality": 30, "method": 6})
        for kw in opts:
            if w * h > 5000 and kw.get("method") == 6 and not lossless:
                continue
            _check(_save(im, "WEBP", lossless=lossless, **kw), ".webp")


def test_webp_lossless_palettes_and_caches():
    """Few colours (colour indexing with 1, 2 and 4-bit bundling) and
    repeats (backward references, the colour cache)."""
    rng = np.random.default_rng(3)
    for n in (2, 3, 11, 40):
        pal = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        a = pal[rng.integers(0, n, (21, 29))]
        a[5:15] = a[0]
        _check(_save(Image.fromarray(a), "WEBP", lossless=True), ".webp")


def _riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(
        tag + struct.pack("<I", len(d)) + d + b"\0" * (len(d) & 1)
        for tag, d in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _webp_chunks(data):
    pos, out = 12, []
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_webp_raw_alpha_with_each_filter(filt):
    """A lossy RGBA file from PIL with its ALPH chunk replaced by raw
    alpha filtered here (libwebp's horizontal, vertical, gradient)."""
    w, h = 23, 14
    rgba = _picture(w, h, 4, 9)
    chunks = _webp_chunks(_save(Image.fromarray(rgba), "WEBP", quality=80))
    alpha = rgba[..., 3].astype(np.int64)
    f = alpha.copy()
    for y in range(h):
        for x in range(w):
            if filt == 0:
                pred = 0
            elif y == 0:
                pred = alpha[0, x - 1] if x else 0
            elif x == 0:
                pred = alpha[y - 1, 0]
            elif filt == 1:
                pred = alpha[y, x - 1]
            elif filt == 2:
                pred = alpha[y - 1, x]
            else:
                g = alpha[y, x - 1] + alpha[y - 1, x] - alpha[y - 1, x - 1]
                pred = min(255, max(0, g))
            f[y, x] = (alpha[y, x] - pred) % 256
    alph = bytes((filt << 2,)) + f.astype(np.uint8).tobytes()
    chunks = [(t, alph if t == b"ALPH" else d) for t, d in chunks]
    assert any(t == b"ALPH" for t, _ in chunks)
    _check(_riff(chunks), ".webp")


def test_webp_first_animation_frame_at_its_offset():
    small = _picture(9, 7, 4, 2)
    vp8l = dict(_webp_chunks(_save(Image.fromarray(small), "WEBP",
                                   lossless=True)))[b"VP8L"]
    second = dict(_webp_chunks(_save(Image.fromarray(small[::-1].copy()),
                                     "WEBP", lossless=True)))[b"VP8L"]

    def anmf(x, y, payload):
        return (b"ANMF", struct.pack("<I", x // 2)[:3]
                + struct.pack("<I", y // 2)[:3] + struct.pack("<I", 8)[:3]
                + struct.pack("<I", 6)[:3] + struct.pack("<I", 100)[:3]
                + bytes((0,)) + b"VP8L" + struct.pack("<I", len(payload))
                + payload + b"\0" * (len(payload) & 1))
    for flags in (0x12, 0x02):  # with and without the alpha flag
        vp8x = bytes((flags, 0, 0, 0)) + struct.pack("<I", 19)[:3] + \
            struct.pack("<I", 14)[:3]
        data = _riff([(b"VP8X", vp8x), (b"ANIM", bytes(6)),
                      anmf(4, 6, vp8l), anmf(0, 0, second)])
        _check(data, ".webp")
    frames = [Image.fromarray(_picture(24, 16, 4, k)) for k in range(3)]
    for lossless in (True, False):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       lossless=lossless, duration=40)
        _check(buf.getvalue(), ".webp")


class _BoolEncoder:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def flush(self):
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _reencode_filter(frame: bytes, simple, sharpness, deltas):
    """The VP8 key frame with its first partition re-encoded: the loop
    filter's type, sharpness and (ref, mode) deltas replaced."""
    readers = []

    class Recorder(vp8._Bool):
        def __init__(self, data):
            super().__init__(data)
            self.log = []
            readers.append(self)

        def bit(self, prob):
            b = super().bit(prob)
            self.log.append((prob, b))
            return b
    bits = frame[0] | frame[1] << 8 | frame[2] << 16
    size0 = bits >> 5
    orig = vp8._Bool
    vp8._Bool = Recorder
    try:
        hd = vp8._parse_header(frame, "x")
        vp8._parse_modes(hd)
    finally:
        vp8._Bool = orig
    log = readers[0].log  # the first partition's
    seq = [b for _, b in log]
    i = 2
    use_seg = seq[i]
    i += 1
    if use_seg:
        update_map, update_data = seq[i], seq[i + 1]
        i += 2
        if update_data:
            i += 1
            for width in (7,) * 4 + (6,) * 4:
                i += 1 + (width + 1 if seq[i] else 0)
        if update_map:
            for _ in range(3):
                i += 1 + (8 if seq[i] else 0)
    level = seq[i + 1:i + 7]
    head = log[:i]
    tail_at = i + 1 + 6 + 3 + 1
    if seq[i + 10]:  # the frame's own deltas: drop them
        j = tail_at
        if seq[j]:
            j += 1
            for _ in range(8):
                j += 1 + (7 if seq[j] else 0)
        else:
            j += 1
        tail_at = j
    new = [(128, simple)] + [(128, b) for b in level]
    new += [(128, (sharpness >> k) & 1) for k in (2, 1, 0)]
    if deltas:
        ref, mode = deltas
        new += [(128, 1), (128, 1)]
        for v in (ref, 0, 0, 0, mode, 0, 0, 0):
            new.append((128, 1))
            new += [(128, (abs(v) >> k) & 1) for k in range(5, -1, -1)]
            new.append((128, int(v < 0)))
    else:
        new.append((128, 0))
    enc = _BoolEncoder()
    for prob, b in head + new + log[tail_at:]:
        enc.put(prob, b)
    p0 = enc.flush()
    tag = (bits & 0x1F) | (len(p0) << 5)
    return bytes((tag & 255, (tag >> 8) & 255, tag >> 16)) + frame[3:10] + \
        p0 + frame[10 + size0:]


@pytest.mark.parametrize("simple,sharpness,deltas", [
    (1, 0, None), (0, 3, None), (0, 6, None), (1, 5, (4, -9)),
    (0, 0, (-7, 12)), (0, 2, (30, 30))])
def test_vp8_loop_filter_variants(simple, sharpness, deltas):
    """libwebp's encoder writes the normal filter without sharpness or
    deltas: these frames are PIL's with the filter header re-encoded."""
    for seed, q in ((1, 20), (2, 70)):
        im = Image.fromarray(_picture(40, 33, 3, seed))
        frame = dict(_webp_chunks(_save(im, "WEBP", quality=q)))[b"VP8 "]
        data = _riff([(b"VP8 ", _reencode_filter(frame, simple, sharpness,
                                                 deltas))])
        assert not isinstance(_pil(data), Exception)
        _check(data, ".webp")


# -------------------------------- JPEG -------------------------------

def _sos(data):
    return [i for i in range(2, len(data) - 1)
            if data[i] == 0xFF and data[i + 1] == 0xDA]


@pytest.mark.parametrize("size", [(17, 13), (40, 24), (33, 71)])
def test_jpeg_cmyk_and_ycck(size):
    im = Image.fromarray(_picture(*size)).convert("CMYK")
    for kw in ({}, {"progressive": True}, {"quality": 40}):
        data = _save(im, "JPEG", **kw)
        _check(data, ".jpg")
        at = data.find(b"Adobe")
        for transform in (1, 2):
            ycck = bytearray(data)
            ycck[at + 11] = transform
            _check(bytes(ycck), ".jpg")


@pytest.mark.parametrize("mode,sub", [("RGB", 0), ("RGB", 2), ("L", 0),
                                      ("RGB", 1)])
@pytest.mark.parametrize("size", [(17, 13), (64, 40), (33, 71)])
def test_jpeg_cut_progressive_is_block_smoothed(mode, sub, size):
    """Every cut of a progressive file after a whole scan, the EOI kept:
    the cuts after the DC scans (DC-only 5 x 5 estimation) and after
    some AC scans (the 5 x 5 AC estimation) both decode as PIL's."""
    im = Image.fromarray(_picture(*size, seed=size[0])).convert(mode)
    data = _save(im, "JPEG", quality=80, progressive=True, subsampling=sub)
    sos = _sos(data)
    assert len(sos) > 4
    for k in range(1, len(sos)):
        _check(data[:sos[k]] + b"\xff\xd9", ".jpg")


# ----------------------------- fixtures ------------------------------

def _fixture_files() -> dict:
    """name -> bytes of every committed fixture, all made here (those of
    test_torch_formats_more.py by its more_fixture_files)."""
    out = {}
    rgb = _picture(32, 24, 3, 11)
    rgba = _picture(32, 24, 4, 12)
    rng = np.random.default_rng(5)
    pal = [tuple(rng.integers(0, 256, 3)) for _ in range(256)]
    idx = rng.integers(0, 16, (24, 32)).astype(np.uint8)
    out["rgb24.bmp"] = _save(Image.fromarray(rgb), "BMP")
    out["grey8.bmp"] = _save(Image.fromarray(rgb[..., 0]), "BMP")
    out["pal4.bmp"] = _bmp(32, 24, 4, _rows(idx, 4), palette=_bgrx(pal[:16]),
                           colors=16)
    out["rle8.bmp"] = _bmp(32, 24, 8, _rle_stream(
        24, 32, 16, False, np.random.default_rng(1), True),
        compression=1, palette=_bgrx(pal[:16]), colors=16)
    out["rle4.bmp"] = _bmp(32, 24, 4, _rle_stream(
        24, 32, 16, True, np.random.default_rng(2)),
        compression=2, palette=_bgrx(pal[:16]), colors=16)
    out["rgb565.bmp"] = _bmp(32, 24, 16, _rows(rng.integers(
        0, 65536, (24, 32)), 16), compression=3, masks=(0xF800, 0x7E0, 0x1F))
    out["rgba32_v5.bmp"] = _bmp(32, 24, 32, _rows(rgba[..., [2, 1, 0, 3]],
                                                  32), hsize=124,
                                compression=3,
                                masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    out["rgb24.tga"] = _save(Image.fromarray(rgb), "TGA")
    out["rgba32_rle.tga"] = _save(Image.fromarray(rgba), "TGA",
                                  compression="tga_rle")
    out["grey8_topleft.tga"] = _save(Image.fromarray(rgb[..., 1]), "TGA",
                                     orientation=1)
    out["cmap16.tga"] = _tga(32, 24, 1, 8, idx.tobytes(), cmap=rng.integers(
        0, 65536, 16).astype("<u2").tobytes(), cmap_depth=16)
    out["rgb16.tga"] = _tga(32, 24, 2, 16, rng.integers(
        0, 65536, 32 * 24).astype("<u2").tobytes(), flags=0x10)
    out["p1.pbm"] = b"P1\n# plain\n8 3\n" + b"\n".join(
        b" ".join(b"%d" % v for v in r) for r in rng.integers(0, 2, (3, 8)))
    out["p4.pbm"] = _save(Image.fromarray(rgb[..., 2]).convert("1"), "PPM")
    out["p2_maxval15.pgm"] = b"P2\n5 3\n15\n" + b"\n".join(
        b" ".join(b"%d" % v for v in r) for r in rng.integers(0, 16, (3, 5)))
    out["p5_16bit.pgm"] = b"P5\n32 24\n65535\n" + rng.integers(
        0, 1024, (24, 32)).astype(">u2").tobytes()
    out["p3.ppm"] = b"P3\n4 2\n255\n" + b" ".join(
        b"%d" % v for v in rng.integers(0, 256, 24))
    out["p6_maxval1000.ppm"] = b"P6\n32 24\n1000\n" + rng.integers(
        0, 1001, (24, 32, 3)).astype(">u2").tobytes()
    out["palette.gif"] = _save(Image.fromarray(rgb).quantize(64), "GIF")
    out["interlaced_transparent.gif"] = _save(
        Image.fromarray(rgb).quantize(16), "GIF", interlace=1,
        transparency=4)
    out["grey.gif"] = _save(Image.fromarray(rgb[..., 0]), "GIF")
    out["local_offset.gif"] = _gif(40, 30, idx, 5, 3, lpal=bytes(
        v for c in pal[:16] for v in c), transparency=2)
    out["rgb_lzw_pred.tif"] = _save(Image.fromarray(rgb), "TIFF",
                                    compression="tiff_lzw",
                                    tiffinfo={317: 2})
    out["rgba_deflate_tiled.tif"] = _save(
        Image.fromarray(rgba), "TIFF", compression="tiff_adobe_deflate",
        tiled=True, tile_width=16, tile_length=16)
    out["grey16_mm.tif"] = _tiff(rng.integers(0, 1000, (24, 32, 1)), 16, 1,
                                 ">", rows_per_strip=5)
    out["pal4_packbits.tif"] = _tiff(idx[..., None], 4, 3,
                                     compression=32773,
                                     colormap=rng.integers(0, 65536, 48))
    out["rgba_assoc_planar.tif"] = _tiff(rgba.astype(np.int64), 8, 2,
                                         extra=(1,), planar=2, compression=8)
    out["bilevel_whiteiszero.tif"] = _save(
        Image.fromarray(rgb[..., 1]).convert("1"), "TIFF",
        compression="packbits")
    out["lossless.webp"] = _save(Image.fromarray(rgba), "WEBP", lossless=True)
    out["lossy.webp"] = _save(Image.fromarray(_picture(64, 64, 3, 13)),
                              "WEBP", quality=75)
    out["lossy_alpha.webp"] = _save(Image.fromarray(_picture(64, 48, 4, 14)),
                                    "WEBP", quality=60)
    frames = [Image.fromarray(_picture(24, 16, 4, k)) for k in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=40)
    out["anim.webp"] = buf.getvalue()
    cmyk = _save(Image.fromarray(rgb).convert("CMYK"), "JPEG", quality=85)
    out["cmyk.jpg"] = cmyk
    ycck = bytearray(cmyk)
    ycck[cmyk.find(b"Adobe") + 11] = 2
    out["ycck.jpg"] = bytes(ycck)
    prog = _save(Image.fromarray(_picture(48, 40, 3, 15)), "JPEG",
                 quality=80, progressive=True)
    sos = _sos(prog)
    out["cut_dc.jpg"] = prog[:sos[1]] + b"\xff\xd9"
    out["cut_ac.jpg"] = prog[:sos[4]] + b"\xff\xd9"
    from test_torch_formats_more import more_fixture_files
    out.update(more_fixture_files())
    return out


def write_fixtures():
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for old in FIXTURES.iterdir():
        old.unlink()
    for name, data in _fixture_files().items():
        (FIXTURES / name).write_bytes(data)
        want = _pil(data)
        assert not isinstance(want, Exception), (name, want)
        Image.fromarray(want).save(FIXTURES / (name + ".png"))
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    print(f"{len(list(FIXTURES.iterdir()))} files, {total} bytes")


def test_committed_fixtures_equal_pil_and_their_pngs():
    """Each committed file decodes in the port as in PIL and equals the
    PNG of PIL's decode beside it (what chip_smoke.py checks without
    PIL); the set is the one _fixture_files makes, under 300 KB."""
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if not p.name.endswith(".png"))
    assert names == sorted(_fixture_files())
    total = 0
    for name in names:
        data = (FIXTURES / name).read_bytes()
        png = FIXTURES / (name + ".png")
        total += len(data) + png.stat().st_size
        got = tio.load_image(FIXTURES / name)
        np.testing.assert_array_equal(got, tio.load_image(png), err_msg=name)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)
    assert total < 300_000


# ----------------------------- save_image ----------------------------

SUFFIXES = (".png", ".bmp", ".tga", ".tif", ".tiff", ".ppm", ".pgm", ".pnm",
            ".PNG", ".Tif")


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_save_image_writes_what_the_suffix_names(tmp_path, suffix):
    rng = np.random.default_rng(len(suffix))
    for shape in ((9, 13), (9, 13, 3), (9, 13, 4), (1, 1, 4)):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        ours, theirs = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
        tio.save_image(ours, a)
        Image.fromarray(a).save(theirs)
        with Image.open(ours) as x, Image.open(theirs) as y:
            assert x.format == y.format and x.mode == y.mode, (shape, suffix)
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        if suffix.lower() in (".bmp", ".tga", ".ppm", ".pgm", ".pnm"):
            assert ours.read_bytes() == theirs.read_bytes(), (shape, suffix)
        np.testing.assert_array_equal(tio.load_image(ours),
                                      _pil(ours.read_bytes()))


@pytest.mark.parametrize("suffix", [".bufr", ".wmf", ".blp", ".msp",
                                    ".exr", ""])
def test_save_image_refuses_other_suffixes(tmp_path, suffix):
    path = tmp_path / f"a{suffix}"
    with pytest.raises(ValueError, match="does not write"):
        tio.save_image(path, np.zeros((4, 4, 3), np.uint8))
    assert not path.exists()
    with pytest.raises(ValueError, match="uint8"):
        tio.save_image(tmp_path / "b.png", np.zeros((4, 4, 2), np.uint8))
    assert not (tmp_path / "b.png").exists()


def test_png_bytes_the_app_streams_are_unchanged():
    """encode_png's bytes for RGB and RGBA frames, as before save_image
    learned other formats (sha256 of the previous implementation's
    output on the same arrays)."""
    rng = np.random.default_rng(16)
    want = {3: "8d301603587155f42a3ca1d8f88ecfc2"
               "0181fe930feb924d17a9830957a752e8",
            4: "5ee594b772159bfe516d775e2263b824"
               "7d73207ae78fd630ddcb4cfcb9813667"}
    for c in (3, 4):
        a = rng.integers(0, 256, (37, 53, c), dtype=np.uint8)
        assert hashlib.sha256(tio.encode_png(a)).hexdigest() == want[c]


# ------------------------ the slice against JAX ----------------------

FORMATS = {"bmp": ("BMP", {}), "tga": ("TGA", {"compression": "tga_rle"}),
           "ppm": ("PPM", {}), "gif": ("GIF", {}),
           "tif": ("TIFF", {"compression": "tiff_lzw"}),
           "webp": ("WEBP", {"quality": 80}),
           "webp_lossless": ("WEBP", {"lossless": True})}


def _maps(tmp_path, fmt, size=64):
    """The ivy material's three maps at size x size in `fmt`."""
    kind, kw = FORMATS[fmt]
    ext = fmt.split("_")[0]
    paths = {}
    for slot, name in (("albedo", "ivy_albedo"), ("normal", "ivy_normal"),
                       ("specular", "ivy_mr")):
        im = Image.open(DEMO / f"{name}.png").resize((size, size))
        p = tmp_path / f"{name}_{fmt}.{ext}"
        im.save(p, kind, **kw)
        paths[slot] = str(p)
    return types.SimpleNamespace(**paths)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_texture_images_match_jax(tmp_path, fmt):
    """render/scenebuild._load_texture_images on a mesh whose three maps
    are in `fmt`: an image for every slot, equal to the JAX package's;
    and the glTF import's mean albedo equal to JAX's."""
    paths = _maps(tmp_path, fmt)
    got = tsb._load_texture_images(paths)
    want = jsb._load_texture_images(paths)
    for slot in ("albedo", "normal", "specular"):
        g, w = getattr(got, slot), getattr(want, slot)
        assert g is not None and w is not None, slot
        np.testing.assert_array_equal(g, w, err_msg=slot)
    np.testing.assert_array_equal(
        tgltf._compute_mean_albedo(Path(paths.albedo)),
        jgltf._compute_mean_albedo(Path(paths.albedo)))


def test_refused_texture_is_none_in_both(tmp_path):
    """Where the JAX package loads no image (a file that is no image), the
    port loads none either; a JPEG 2000 file, which the port refused until
    it read JPEG 2000 (an IM file until it read IM), loads in both, equal
    to PIL's decode."""
    bad = tmp_path / "bad.tga"
    bad.write_bytes(b"not an image at all")
    paths = types.SimpleNamespace(albedo=str(bad), normal="", specular=None)
    got, want = tsb._load_texture_images(paths), \
        jsb._load_texture_images(paths)
    assert got.albedo is None and want.albedo is None
    im = tmp_path / "a.jp2"
    Image.fromarray(_picture(8, 8)).save(im)
    np.testing.assert_array_equal(tio.load_image(im), _pil(im.read_bytes()))
    paths = types.SimpleNamespace(albedo=str(im), normal="", specular=None)
    got, want = tsb._load_texture_images(paths), \
        jsb._load_texture_images(paths)
    assert got.albedo is not None and want.albedo is not None
    np.testing.assert_array_equal(got.albedo, want.albedo)


def test_gltf_with_webp_and_tga_textures_imports_as_the_reference(tmp_path):
    """A courtyard copy whose stone albedo is lossy WebP and wood albedo
    TGA: both packages import the glTF to the same .plain bytes (paths,
    mean albedo), and their render scenes to the same texture pool."""
    for p in [DEMO / "courtyard.gltf", DEMO / "courtyard.bin",
              *DEMO.glob("*.png")]:
        shutil.copy(p, tmp_path)
    Image.open(tmp_path / "stone_albedo.png").resize((128, 128)).save(
        tmp_path / "stone_albedo.webp", quality=85)
    Image.open(tmp_path / "wood_albedo.png").save(
        tmp_path / "wood_albedo.tga", compression="tga_rle")
    doc = json.loads((tmp_path / "courtyard.gltf").read_text())
    swaps = {"stone_albedo.png": "stone_albedo.webp",
             "wood_albedo.png": "wood_albedo.tga"}
    for image in doc["images"]:
        image["uri"] = swaps.get(image.get("uri"), image.get("uri"))
    (tmp_path / "courtyard.gltf").write_text(json.dumps(doc))
    for old in swaps:
        (tmp_path / old).unlink()
    t_scene = tgltf.load_model_gltf(tmp_path / "courtyard.gltf")
    j_scene = jgltf.load_model_gltf(tmp_path / "courtyard.gltf")
    swapped = [m for m in t_scene.meshes if m.texture_paths.albedo.endswith(
        (".webp", ".tga"))]
    assert len(swapped) >= 2
    assert not any((m.mean_albedo == 0.5).all() for m in swapped)
    tplain.save_binary_scene(tmp_path / "t.plain",
                             tplain.scene_to_binary(t_scene))
    jplain.save_binary_scene(tmp_path / "j.plain",
                             jplain.scene_to_binary(j_scene))
    assert (tmp_path / "t.plain").read_bytes() == \
        (tmp_path / "j.plain").read_bytes()
    t_rs, j_rs = tsb.build_render_scene(t_scene), \
        jsb.build_render_scene(j_scene)
    for key in ("tex_info", "tex_word0", "tex_word1", "material_table"):
        a, b = getattr(t_rs, key, None), getattr(j_rs, key, None)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=key)


def time_fixtures(repeats=3):
    """The best of `repeats` load_image wall times per fixture, in ms."""
    for p in sorted(FIXTURES.iterdir()):
        if p.name.endswith(".png"):
            continue
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            tio.load_image(p)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{p.name}: {min(times):.2f} ms", flush=True)


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
    else:
        time_fixtures()
