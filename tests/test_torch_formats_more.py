"""The port's readers and writers added after test_torch_formats.py
(assets/tiff.py's JPEG, CMYK, YCbCr, float, BigTIFF and orientation
support; psd.py, qoi.py, sgi.py, pcx.py, ico.py and bmp.py's bare DIB;
jpeg_encode.py and save_image's JPEG, QOI, SGI, PCX and PBM) against
PIL, which the JAX package's load_image and save_image use:

  - every reader equals ``np.asarray(Image.open(p).convert("RGBA"))`` bit
    for bit on files PIL writes here (several sizes, odd widths, 1 x 1)
    and on files this test builds itself where PIL writes none (SGI
    run-length and 16-bit files, PSD, CUR and ICO bitmaps, 1-, 2- and
    4-bit PCX, DCX, TIFF YCbCr with subsampling and with JPEG);
  - what PIL refuses too raises ValueError naming the feature;
  - save_image byte for byte as PIL's save for JPEG, QOI, SGI, PCX and
    PBM, refusing what PIL refuses;
  - the texture loads: the port's _load_texture_images equals the JAX
    package's on maps in each newly read format, and the courtyard's RGB
    maps written as JPEG have the digests chip_smoke.py checks on the
    card's machine.

Everything here is numpy and PIL on small images; no frame is rendered.
"""

import hashlib
import io
import lzma
import struct
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.assets import jpeg_encode
from plainrenderer_tpu_torch.render import scenebuild as tsb
from test_torch_formats import (_check, _images, _packbits, _picture, _pil,
                                _refused, _save, _tiff)

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
SIZES = ((1, 1), (7, 5), (33, 17))


def _flat_picture(w, h, c, seed):
    """Blocks of equal pixels with some noise: runs, repeats and small
    steps for the run-length and QOI codes."""
    rng = np.random.default_rng(seed)
    a = np.repeat(np.repeat(rng.integers(0, 256, (h // 4 + 1, w // 5 + 1, c)),
                            4, 0), 5, 1)[:h, :w]
    a[rng.random((h, w)) < 0.2] += rng.integers(-2, 3, c)
    return np.clip(a, 0, 255).astype(np.uint8)


# -------------------------------- QOI --------------------------------

@pytest.mark.parametrize("size", SIZES + ((130, 3),))
def test_qoi_read_and_written_as_pil(size):
    """PIL's QOI files decode equal; the port's writer is byte-equal to
    PIL's for RGB and RGBA (long runs, index hits, every op)."""
    for c in (3, 4):
        for a in (_picture(*size, c, 1), _flat_picture(*size, c, 2)):
            data = _save(Image.fromarray(a), "QOI")
            _check(data, ".qoi")
            assert tio.qoi.encode_qoi(a) == data


def _qoi(w, h, channels, ops: bytes) -> bytes:
    return (b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops
            + bytes(7) + b"\x01")


def test_qoi_ops_built_here():
    """PIL's decoder quirks: a run at the start (its pixel never enters
    the index), an index op on a slot never written, an RGBA op in a
    3-channel file (its alpha carried in the hashes)."""
    cases = [
        _qoi(4, 2, 4, bytes([0xC1, 53, 0xFF, 9, 8, 7, 100, 0x40 | 0x3F, 21,
                             0x80 | 40, 0x5A, 0xC0])),
        _qoi(3, 2, 3, bytes([0xFF, 1, 2, 3, 4, 0xFE, 200, 100, 50, 0x67,
                             0x15, 0x80, 0x88, 0xC0])),
        _qoi(2, 2, 4, bytes([0x00, 0x05, 0xFE, 0, 0, 0, 0xC1])),
    ]
    for data in cases:
        _check(data, ".qoi")


def test_qoi_writer_refuses_grey(tmp_path):
    with pytest.raises(ValueError, match="QOI"):
        tio.save_image(tmp_path / "a.qoi", np.zeros((4, 4), np.uint8))
    assert not (tmp_path / "a.qoi").exists()
    with pytest.raises(Exception, match="QOI"):
        _save(Image.fromarray(np.zeros((4, 4), np.uint8)), "QOI")


# -------------------------------- SGI --------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_sgi_written_by_pil(size):
    ims = _images(*size)
    for mode in ("L", "RGB", "RGBA"):
        for bpc in (1, 2):
            _check(_save(ims[mode], "SGI", bpc=bpc), ".sgi")


def _sgi_rle_row(row: np.ndarray, bpc: int, rng) -> bytes:
    """One row's run-length code: alternating literal and repeat runs of
    up to 127 samples, then the terminator."""
    out, x, n = [], 0, row.size
    word = ">H" if bpc == 2 else "B"
    while x < n:
        k = int(min(n - x, rng.integers(1, 128)))
        if rng.random() < 0.5:
            differs = row[x:x + k] != row[x]
            k = int(np.argmax(differs)) if differs.any() else k
            out.append(struct.pack(word, k) + struct.pack(word, int(row[x])))
        else:
            out.append(struct.pack(word, 0x80 | k) + b"".join(
                struct.pack(word, int(v)) for v in row[x:x + k]))
        x += k
    out.append(struct.pack(word, 0))
    return b"".join(out)


def _sgi_rle(img: np.ndarray, bpc: int, dimension: int, seed=0,
             storage=1) -> bytes:
    """A run-length SGI file of (H, W, Z) samples (bottom row first)."""
    rng = np.random.default_rng(seed)
    h, w, z = img.shape
    head = struct.pack(">HBBHHHHll", 474, storage, bpc, dimension, w, h, z, 0,
                       (1 << 8 * bpc) - 1).ljust(512, b"\0")
    rows, starts, lengths = [], [], []
    at = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            code = _sgi_rle_row(img[h - 1 - y, :, c], bpc, rng)
            starts.append(at)
            lengths.append(len(code))
            rows.append(code)
            at += len(code)
    return (head + struct.pack(f">{h * z}I", *starts)
            + struct.pack(f">{h * z}I", *lengths) + b"".join(rows))


@pytest.mark.parametrize("bpc", [1, 2])
def test_sgi_run_length_built_here(bpc):
    rng = np.random.default_rng(bpc)
    for z, dim in ((1, 2), (3, 3), (4, 3), (1, 1)):
        for w, h in ((1, 1), (37, 9), (130, 3)):
            h = 1 if dim == 1 else h
            img = _flat_picture(w, h, z, w + z).astype(np.int64)
            if bpc == 2:
                img = img * 257 + rng.integers(0, 256, img.shape)
            _check(_sgi_rle(img, bpc, dim, seed=w), ".sgi")


def test_sgi_refusals_name_the_feature():
    img = np.ones((3, 4, 2), np.int64)
    _refused(_sgi_rle(img, 1, 3), ".sgi", "2 channels", False)
    over = (struct.pack(">HBBHHHHll", 474, 1, 1, 2, 4, 1, 1, 0, 255)
            .ljust(512, b"\0") + struct.pack(">II", 520, 3)
            + b"\x05\x01\x00")  # a run of 5 in a row of 4
    _refused(over, ".sgi", "overruns", False)
    _refused(_sgi_rle(np.ones((3, 4, 3), np.int64), 1, 3, storage=2), ".sgi",
             "storage", False)


# -------------------------------- PCX --------------------------------

@pytest.mark.parametrize("size", SIZES + ((8, 3), (16, 2)))
def test_pcx_written_by_pil(size):
    ims = _images(*size)
    for mode in ("1", "L", "P", "RGB"):
        data = _save(ims[mode], "PCX")
        if mode == "RGB" and size[0] == 1:
            # PIL moves no planes together at width 1 and runs out of data
            _refused(data, ".pcx", "truncated", False)
            continue
        _check(data, ".pcx")


def _pcx_rle(lines: np.ndarray) -> bytes:
    out = bytearray()
    for line in lines:
        x = 0
        while x < line.size:
            k = 1
            while x + k < line.size and line[x + k] == line[x] and k < 63:
                k += 1
            if k == 1 and line[x] < 0xC0:
                out.append(line[x])
            else:
                out += bytes((0xC0 | k, line[x]))
            x += k
    return bytes(out)


def _pcx(w, h, version, bits, planes, lines, stride, palette16=b"",
         tail=b""):
    head = (bytes((10, version, 1, bits)) + struct.pack(
        "<HHHHHH", 0, 0, w - 1, h - 1, 72, 72) + palette16.ljust(48, b"\0")
        + b"\0" + bytes((planes,)) + struct.pack("<HH", stride, 1)
        + bytes(58))
    return head + _pcx_rle(lines) + tail


def _planar_lines(idx: np.ndarray, planes: int, stride: int) -> np.ndarray:
    h, w = idx.shape
    out = np.zeros((h, planes, stride), np.uint8)
    for p in range(planes):
        bits = (idx >> p) & 1
        packed = np.packbits(bits.astype(np.uint8), axis=1)
        out[:, p, :packed.shape[1]] = packed
    return out.reshape(h, planes * stride)


@pytest.mark.parametrize("planes", [1, 2, 4])
def test_pcx_bit_planes_built_here(planes):
    """1-, 2- and 4-bit palettes as 1-bit planes, with the header's
    stride odd, even and padded (PIL reads the padded planes shifted)."""
    rng = np.random.default_rng(planes)
    pal = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    for w, h in ((1, 1), (8, 3), (17, 5), (40, 2)):
        idx = rng.integers(0, 1 << planes, (h, w))
        span = (w + 7) // 8
        for stride in sorted({span, span + span % 2}):
            lines = _planar_lines(idx, planes, stride)
            _check(_pcx(w, h, 5, 1, planes, lines, stride, pal), ".pcx")


def test_pcx_layouts_built_here():
    """8-bit grey without a palette, a grey-ramp palette (L) and another
    (P), 24-bit planes, runs of bytes >= 0xC0; a DCX's first page."""
    rng = np.random.default_rng(3)
    for w, h in ((5, 3), (16, 4)):
        idx = _flat_picture(w, h, 1, w)[..., 0] | 0xC0 * (
            rng.random((h, w)) < 0.3)
        stride = w + w % 2
        lines = np.zeros((h, stride), np.uint8)
        lines[:, :w] = idx
        ramp = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
        pal = b"\x0c" + rng.integers(0, 256, 768).astype(np.uint8).tobytes()
        for tail in (b"", ramp, pal):
            _check(_pcx(w, h, 5, 8, 1, lines, stride, tail=tail), ".pcx")
        rgb = _flat_picture(w, h, 3, 7).transpose(0, 2, 1)
        planes = np.zeros((h, 3, stride), np.uint8)
        planes[..., :w] = rgb
        page = _pcx(w, h, 5, 8, 3, planes.reshape(h, -1), stride)
        _check(page, ".pcx")
        second = _pcx(w, h, 5, 8, 1, lines, stride)
        dcx = struct.pack("<III", 987654321, 16, 16 + len(page)) + bytes(4)
        _check(dcx + page + second, ".dcx")


def test_pcx_refusals_name_the_feature():
    lines = np.zeros((2, 4), np.uint8)
    _refused(_pcx(4, 2, 3, 8, 1, lines, 4), ".pcx", "unknown PCX mode", False)
    _refused(_pcx(4, 2, 5, 4, 1, lines, 4), ".pcx", "unknown PCX mode", False)
    cross = (bytes((10, 5, 1, 8)) + struct.pack("<HHHHHH", 0, 0, 3, 1, 72, 72)
             + bytes(49) + b"\x01" + struct.pack("<HH", 4, 1) + bytes(58)
             + b"\xc6\x07\xc2\x07")
    _refused(cross, ".pcx", "crosses", False)


# ------------------------------ ICO / CUR -----------------------------

@pytest.mark.parametrize("size", ((16, 16), (33, 17), (48, 40)))
def test_ico_written_by_pil(size):
    for mode, im in _images(*size).items():
        if mode != "I;16":
            _check(_save(im, "ICO"), ".ico")
        if mode in ("1", "L", "P", "RGB", "RGBA"):
            _check(_save(im, "DIB"), ".dib")


def _dib(rgba_or_idx, bits, palette=None, mask=None, height_factor=2):
    """A BITMAPINFOHEADER DIB of an icon: the XOR bitmap (bits 1, 4, 8 with
    `palette` (N, 3), 24 or 32) and the AND mask (1 transparent)."""
    a = np.asarray(rgba_or_idx)
    h, w = a.shape[:2]
    stride = ((w * bits + 31) >> 5) << 2
    rows = np.zeros((h, stride), np.uint8)
    if bits <= 8:
        packed = np.packbits(((a[..., None] >> np.arange(bits - 1, -1, -1))
                              & 1).astype(np.uint8).reshape(h, -1), axis=1)
        rows[:, :packed.shape[1]] = packed
    else:
        rows[:, :w * bits // 8] = a[..., [2, 1, 0, 3][:bits // 8]].reshape(
            h, -1)
    pal = b"" if palette is None else b"".join(
        bytes((b, g, r, 0)) for r, g, b in np.asarray(palette))
    head = struct.pack("<IiiHHIIiiII", 40, w, h * height_factor, 1, bits, 0,
                       0, 0, 0, 0 if palette is None else len(palette), 0)
    m = np.zeros((h, w), np.uint8) if mask is None else mask
    mstride = ((w + 31) >> 5) << 2
    mrows = np.zeros((h, mstride), np.uint8)
    packed = np.packbits(m, axis=1)
    mrows[:, :packed.shape[1]] = packed
    return head + pal + rows[::-1].tobytes() + mrows[::-1].tobytes()


def _icon_dir(magic: bytes, entries) -> bytes:
    """entries: (width, height, colours, bpp, image bytes)."""
    out, blobs = magic + struct.pack("<H", len(entries)), b""
    at = 6 + 16 * len(entries)
    for w, h, colours, bpp, blob in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, 1, bpp,
                           len(blob), at + len(blobs))
        blobs += blob
    return out + blobs


def test_ico_bitmaps_built_here():
    """BMP entries at 1, 4, 8, 24 and 32 bits with AND masks (32 bits:
    the fourth byte is alpha); the entry PIL picks among several (largest,
    then least depth); PNG entries (a palette with transparency loses
    it, as PIL's icon does)."""
    rng = np.random.default_rng(5)
    for w, h in ((16, 16), (5, 3), (33, 2)):
        mask = (rng.random((h, w)) < 0.3).astype(np.uint8)
        rgba = _picture(w, h, 4, w)
        pal = rng.integers(0, 256, (16, 3))
        entries = {
            32: _dib(rgba, 32, mask=mask), 24: _dib(rgba, 24, mask=mask),
            8: _dib(rng.integers(0, 16, (h, w)), 8, pal, mask),
            4: _dib(rng.integers(0, 16, (h, w)), 4, pal, mask),
            1: _dib(rng.integers(0, 2, (h, w)), 1, pal[:2], mask)}
        for bpp, blob in entries.items():
            _check(_icon_dir(b"\0\0\1\0", [(w, h, 0, bpp, blob)]), ".ico")
        small = _dib(_picture(4, 4, 4, 1), 32)
        _check(_icon_dir(b"\0\0\1\0", [(4, 4, 0, 32, small),
                                       (w, h, 0, 32, entries[32]),
                                       (w, h, 16, 0, entries[4]),
                                       (w, h, 0, 8, entries[8])]), ".ico")
    p = Image.fromarray(_picture(9, 7)).quantize(8)
    p.info["transparency"] = 3
    for im in (p, Image.fromarray(_picture(9, 7, 4))):
        buf = io.BytesIO()
        im.save(buf, "PNG", transparency=3) if im.mode == "P" else im.save(
            buf, "PNG")
        _check(_icon_dir(b"\0\0\1\0", [(9, 7, 0, 32, buf.getvalue())]),
               ".ico")


def test_cur_built_here():
    """CUR: the entry larger in both sides wins; 32-bit pixels keep alpha
    only in a bitmap at byte 22 (a one-entry file); no AND mask."""
    rgba = _picture(12, 10, 4, 3)
    one = _dib(rgba, 32)
    _check(_icon_dir(b"\0\0\2\0", [(12, 10, 0, 32, one)]), ".cur")
    two = [(12, 10, 0, 24, _dib(rgba, 24)),
           (4, 20, 0, 32, _dib(_picture(4, 20, 4, 1), 32)),
           (16, 16, 0, 32, _dib(_picture(16, 16, 4, 2), 32))]
    _check(_icon_dir(b"\0\0\2\0", two), ".cur")
    _check(_icon_dir(b"\0\0\2\0", two[:2]), ".cur")


# -------------------------------- PSD --------------------------------

def _psd(mode, bits, planes, compression=0, n_channels=None,
         colour=b"", resources=b"", layers=b""):
    """A PSD of `planes` (C, H, row bytes) with its merged image raw (0),
    PackBits (1) or under another compression code (no data)."""
    planes = np.asarray(planes, np.uint8)
    c, h = planes.shape[:2]
    w = planes.shape[2] * 8 if bits == 1 else planes.shape[2]
    head = (b"8BPS" + struct.pack(">H", 1) + bytes(6)
            + struct.pack(">HIIHH", n_channels or c, h, w, bits, mode)
            + struct.pack(">I", len(colour)) + colour
            + struct.pack(">I", len(resources)) + resources
            + struct.pack(">I", len(layers)) + layers
            + struct.pack(">H", compression))
    if compression == 0:
        return head + planes.tobytes()
    if compression != 1:
        return head
    rows = [_packbits(r.tobytes()) for r in planes.reshape(-1, planes.shape[2])]
    return head + b"".join(struct.pack(">H", len(r)) for r in rows) + \
        b"".join(rows)


def _resource(rid: int, name: bytes, data: bytes) -> bytes:
    pascal = bytes((len(name),)) + name
    pascal += b"\0" * (len(pascal) & 1)
    return (b"8BIM" + struct.pack(">H", rid) + pascal
            + struct.pack(">I", len(data)) + data + b"\0" * (len(data) & 1))


@pytest.mark.parametrize("compression", [0, 1])
def test_psd_built_here(compression):
    """Bitmap, grey, duotone, multichannel, indexed, RGB, RGBA, CMYK, with
    extra channels as PIL treats them (and its PackBits offsets for
    them), resources and a layer section skipped."""
    rng = np.random.default_rng(compression)
    res = _resource(1005, b"", bytes(16)) + _resource(1039, b"icc", b"abc")
    for w, h in ((1, 1), (13, 7), (32, 9)):
        def planes(c):
            return _flat_picture(w, h, c, w + c).transpose(2, 0, 1)
        bitmap = np.packbits(rng.integers(0, 2, (h, w)).astype(np.uint8),
                             axis=1)[None]
        pal = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
        cases = [_psd(0, 1, bitmap, compression),
                 _psd(1, 8, planes(1), compression, resources=res),
                 _psd(1, 8, planes(2), compression),
                 _psd(8, 8, planes(1), compression, colour=b"duo" * 5),
                 _psd(7, 8, planes(3), compression),
                 _psd(2, 8, planes(1), compression, colour=pal),
                 _psd(3, 8, planes(3), compression, layers=bytes(12)),
                 _psd(3, 8, planes(4), compression),
                 _psd(3, 8, planes(5), compression),
                 _psd(4, 8, planes(4), compression),
                 _psd(4, 8, planes(5), compression)]
        for data in cases:
            _check(data, ".psd")


def test_psd_refusals_name_the_feature():
    _refused(_psd(3, 16, np.ones((3, 2, 8))), ".psd", "16-bit", False)
    _refused(_psd(9, 16, np.ones((3, 2, 8))), ".psd", "Lab", False)
    _refused(_psd(3, 8, np.ones((2, 2, 4))), ".psd", "channels", False)
    psb = bytearray(_psd(1, 8, np.ones((1, 2, 4))))
    psb[5] = 2
    _refused(bytes(psb), ".psd", "PSB", False)
    _refused(_psd(3, 8, np.ones((3, 4, 5)), 2), ".psd", "ZIP", False)


# -------------------------------- TIFF -------------------------------

@pytest.mark.parametrize("size", SIZES + ((40, 24),))
def test_tiff_jpeg_cmyk_float_and_bigtiff_written_by_pil(size):
    img = Image.fromarray(_picture(*size, 3, 9))
    rng = np.random.default_rng(size[0])
    f = rng.normal(100, 150, size[::-1]).astype(np.float32)
    f.flat[:4] = [np.nan, np.inf, -np.inf, 254.9][:f.size]
    fimg = Image.fromarray(f, "F")
    for kw in ({}, {"compression": "tiff_lzw"},
               {"compression": "tiff_adobe_deflate"},
               {"compression": "packbits"}):
        _check(_save(img.convert("CMYK"), "TIFF", **kw), ".tif")
        _check(_save(fimg, "TIFF", **kw), ".tif")
        _check(_save(img, "TIFF", big_tiff=True, **kw), ".tif")
        if kw:  # uncompressed YCbCr: test_tiff_layouts_built_here
            _check(_save(img.convert("YCbCr"), "TIFF", **kw), ".tif")
    _check(_save(fimg, "TIFF", compression="tiff_adobe_deflate",
                 tiffinfo={317: 3}), ".tif")
    _check(_save(fimg, "TIFF", compression="tiff_lzw", tiffinfo={317: 3}),
           ".tif")
    for im in (img, img.convert("L"), img.convert("CMYK")):
        for q in (75, 95):
            _check(_save(im, "TIFF", compression="jpeg", quality=q), ".tif")
    _check(_save(img, "TIFF", compression="jpeg", big_tiff=True), ".tif")


def _tiff_file(w, h, chunks, tags, bo="<", big=False, tiled=None):
    """A one-page TIFF around pre-coded strips (or tiles, `tiled` = (tile
    width, tile length)); `tags` maps tag -> (type, values) or bytes."""
    data_at = 16 if big else 8
    offsets, pos = [], data_at
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    blob = b"".join(chunks)
    t = dict(tags)
    t.update({256: (4, [w]), 257: (4, [h])})
    if tiled:
        t.update({322: (3, [tiled[0]]), 323: (3, [tiled[1]]),
                  324: (16 if big else 4, offsets),
                  325: (4, [len(c) for c in chunks])})
    else:
        t.update({273: (16 if big else 4, offsets),
                  279: (4, [len(c) for c in chunks])})
    ifd_at = data_at + len(blob) + (len(blob) & 1)
    entry, inline, cnt = (20, 8, "Q") if big else (12, 4, "I")
    head_n = 8 if big else 2
    extra_at = ifd_at + head_n + entry * len(t) + (8 if big else 4)
    entries, extras = b"", b""
    for tag in sorted(t):
        v = t[tag]
        if isinstance(v, bytes):
            typ, packed, n = 7, v, len(v)
        else:
            typ, vals = v
            f = {3: "H", 4: "I", 5: "II", 16: "Q"}[typ]
            flat = [x for pair in vals for x in pair] if typ == 5 else vals
            packed, n = struct.pack(bo + f[0] * len(flat), *flat), len(vals)
        if len(packed) <= inline:
            value = packed.ljust(inline, b"\0")
        else:
            value = struct.pack(bo + cnt, extra_at + len(extras))
            extras += packed + b"\0" * (len(packed) & 1)
        entries += struct.pack(bo + "HH" + cnt, tag, typ, n) + value
    if big:
        head = (b"II+\0" if bo == "<" else b"MM\0+") + struct.pack(
            bo + "HHQ", 8, 0, ifd_at)
        count = struct.pack(bo + "Q", len(t))
    else:
        head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(
            bo + "I", ifd_at)
        count = struct.pack(bo + "H", len(t))
    pad = b"\0" * (ifd_at - data_at - len(blob))
    return (head + blob + pad + count + entries
            + bytes(8 if big else 4) + extras)


def _ycbcr_units(ycc: np.ndarray, hs, vs) -> bytes:
    """(H, W, 3) YCbCr -> data units: hs x vs Y samples, then Cb, Cr (the
    unit's top-left chroma), the edges replicated to whole units."""
    h, w = ycc.shape[:2]
    ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
    p = np.pad(ycc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    y = p[..., 0].reshape(ph // vs, vs, pw // hs, hs).transpose(0, 2, 1, 3)
    units = np.concatenate((y.reshape(ph // vs, pw // hs, hs * vs),
                            p[::vs, ::hs, 1:]), axis=2)
    return units.astype(np.uint8).tobytes()


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2),
                                 (4, 4)])
def test_tiff_ycbcr_subsampled_built_here(sub):
    """YCbCr through libtiff's RGBA interface: data units, chroma on each
    unit's pixels, its fixed-point conversion (default and explicit
    coefficients and reference black and white), in strips and tiles,
    LZW and Deflate."""
    hs, vs = sub
    rng = np.random.default_rng(hs * 10 + vs)
    for w, h in ((8, 8), (13, 11), (33, 6)):
        ycc = rng.integers(0, 256, (h, w, 3))
        base = {258: (3, [8, 8, 8]), 262: (3, [6]), 277: (3, [3]),
                530: (3, [hs, vs])}
        rps = 2 * vs
        strips = [zlib.compress(_ycbcr_units(ycc[y:y + rps], hs, vs))
                  for y in range(0, h, rps)]
        _check(_tiff_file(w, h, strips, {**base, 259: (3, [8]),
                                         278: (4, [rps])}), ".tif")
        coef = {529: (5, [(2990, 10000), (5870, 10000), (1140, 10000)]),
                532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                          (240, 1)])}
        _check(_tiff_file(w, h, strips, {**base, **coef, 259: (3, [8]),
                                         278: (4, [rps])}), ".tif")
        tw, th = 16, 8
        tiles = []
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                t = np.zeros((th, tw, 3), np.int64)
                part = ycc[ty:ty + th, tx:tx + tw]
                t[:part.shape[0], :part.shape[1]] = part
                tiles.append(zlib.compress(_ycbcr_units(t, hs, vs)))
        _check(_tiff_file(w, h, tiles, {**base, 259: (3, [32946])},
                          tiled=(tw, th)), ".tif")


def _jpeg_tiff_parts(rgb: np.ndarray, subsampling: int, quality=90):
    """PIL's JPEG of `rgb` split as libtiff stores it: the tables
    (SOI, DQT, DHT, EOI) and the abbreviated stream (SOF, SOS, data)."""
    data = _save(Image.fromarray(rgb), "JPEG", quality=quality,
                 subsampling=subsampling)
    tables, stream, i = b"\xff\xd8", b"\xff\xd8", 2
    while True:
        marker, length = data[i + 1], struct.unpack_from(">H", data, i + 2)[0]
        seg = data[i:i + 2 + length]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif marker != 0xE0:
            stream += seg
        i += 2 + length
        if marker == 0xDA:
            return tables + b"\xff\xd9", stream + data[i:]


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2)])
def test_tiff_jpeg_ycbcr_built_here(sub):
    """Photometric YCbCr with JPEG compression and JPEGTables, in strips
    (the last one shorter) and tiles, converted by libjpeg; a stream whose
    sampling differs from the tag is refused, as libtiff refuses it."""
    code = {(1, 1): 0, (2, 1): 1, (2, 2): 2}[sub]
    for w, h, rps in ((16, 16, 16), (23, 21, 8), (40, 9, 16)):
        rgb = _picture(w, h, 3, w)
        strips, tables = [], None
        for y in range(0, h, rps):
            tables, stream = _jpeg_tiff_parts(rgb[y:y + rps], code)
            strips.append(stream)
        tags = {258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]),
                277: (3, [3]), 278: (4, [rps]), 347: tables,
                530: (3, list(sub))}
        _check(_tiff_file(w, h, strips, tags), ".tif")
        _check(_tiff_file(w, h, strips, tags, big=True), ".tif")
        tiles = []
        for ty in range(0, h, 16):
            for tx in range(0, w, 16):
                t = np.zeros((16, 16, 3), np.uint8)
                part = rgb[ty:ty + 16, tx:tx + 16]
                t[:part.shape[0], :part.shape[1]] = part
                tiles.append(_jpeg_tiff_parts(t, code)[1])
        tiled = {k: v for k, v in tags.items() if k != 278}
        _check(_tiff_file(w, h, tiles, tiled, tiled=(16, 16)), ".tif")
    wrong = {**tags, 530: (3, [1, 2])}
    _refused(_tiff_file(w, h, strips, wrong), ".tif", "sampling", False)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientations(orientation):
    """PIL transposes by the Orientation tag after loading (its size
    swapped for 5-8), whatever the compression."""
    rng = np.random.default_rng(orientation)
    for comp in (1, 8, 32773):
        for shape in ((5, 7, 1), (4, 9, 3)):
            s = rng.integers(0, 256, shape)
            _check(_tiff(s, 8, 1 if shape[2] == 1 else 2, compression=comp,
                         orientation=orientation), ".tif")
    img = Image.fromarray(_picture(11, 6))
    _check(_save(img, "TIFF", compression="jpeg",
                 tiffinfo={274: orientation}), ".tif")


def test_tiff_layouts_built_here():
    """Big-endian floats (PIL unpacks libtiff's native floats as
    big-endian), 16-bit CMYK, CMYK with extra samples, uncompressed YCbCr
    as PIL's raw decoder reads it (4 bytes a pixel), a 1-sample YCbCr
    file, a BigTIFF with 8-byte offsets built here."""
    rng = np.random.default_rng(7)
    f = rng.normal(50, 120, (6, 9, 1)).astype(np.float32)
    bits = f.view(np.uint32).astype(np.int64)
    for comp in (1, 8):
        for bo in "<>":
            _check(_tiff(bits, 32, 1, bo, compression=comp, sample_format=3),
                   ".tif")
    _check(_tiff(bits, 32, 1, compression=8, predictor=2, sample_format=3),
           ".tif")
    for bo in "<>":
        _check(_tiff(rng.integers(0, 65536, (5, 7, 4)), 16, 5, bo), ".tif")
    _check(_tiff(rng.integers(0, 256, (5, 7, 5)), 8, 5, extra=(0,),
                 compression=8), ".tif")
    _check(_tiff(rng.integers(0, 256, (5, 7, 6)), 8, 5, extra=(0, 0)),
           ".tif")
    _check(_tiff(rng.integers(0, 256, (3, 4, 3)), 8, 6), ".tif")
    _check(_tiff(rng.integers(0, 256, (3, 4, 3)), 8, 6, rows_per_strip=1),
           ".tif")
    _check(_tiff(rng.integers(0, 256, (5, 7, 1)), 8, 6), ".tif")
    rgb = rng.integers(0, 256, (7, 5, 3)).astype(np.uint8)
    strips = [zlib.compress(rgb[y:y + 3].tobytes()) for y in range(0, 7, 3)]
    _check(_tiff_file(5, 7, strips, {258: (3, [8, 8, 8]), 259: (3, [8]),
                                     262: (3, [2]), 277: (3, [3]),
                                     278: (4, [3])}, big=True), ".tif")


def test_tiff_refusals_still_name_the_feature():
    """What PIL refuses too, by name; the LZMA and CCITT files PIL reads
    are read now, equal to PIL's decode (more in
    tests/test_torch_formats_codecs.py)."""
    rng = np.random.default_rng(1)
    img = Image.fromarray(_picture(16, 8))
    rgb = rng.integers(0, 256, (4, 5, 3)).astype(np.uint8)
    base = {258: (3, [8, 8, 8]), 262: (3, [2]), 277: (3, [3]),
            278: (4, [4])}
    _check(_tiff_file(5, 4, [lzma.compress(rgb.tobytes())],
                      {**base, 259: (3, [34925])}), ".tif")
    # this PIL's libtiff has no WebP or JPEG 2000 codec; the ZSTD and
    # old-style JPEG strips here hold raw samples, which PIL refuses as bad
    # data (PIL writes real ZSTD TIFFs, which the port reads)
    for comp, name in ((50000, "ZSTD"), (50001, "WebP"),
                       (34712, "JPEG 2000"), (6, "old-style JPEG")):
        _refused(_tiff_file(5, 4, [rgb.tobytes()], {**base, 259: (3, [comp])}),
                 ".tif", name, False)
    for comp in ("group3", "group4"):
        _check(_save(img.convert("1"), "TIFF", compression=comp), ".tif")
    _refused(_tiff(rng.integers(0, 256, (4, 4, 3)), 8, 10), ".tif",
             "ITULab", False)
    _refused(_tiff(rng.integers(0, 256, (4, 4, 1)), 8, 6, compression=8),
             ".tif", "YCbCr", False)
    _refused(_tiff(rng.integers(0, 256, (19, 11, 3)), 8, 6), ".tif",
             "truncated", False)
    _refused(_tiff(rng.integers(0, 65536, (4, 4, 1)), 16, 1,
                   sample_format=3), ".tif", "SampleFormat", False)
    _refused(_tiff(rng.integers(0, 256, (4, 4, 1)), 8, 1, compression=8,
                   predictor=3), ".tif", "floating-point predictor", False)


# ----------------------------- save_image ----------------------------

JPEG_SIZES = ((1, 1), (7, 13), (17, 9), (64, 64))


@pytest.mark.parametrize("suffix", [".jpg", ".jpeg", ".jpe", ".jfif",
                                    ".JPG"])
def test_save_image_writes_jpeg_as_pil(tmp_path, suffix):
    """The bytes of PIL's default save (quality 75, 4:2:0, the standard
    tables) for grey and RGB; RGBA refused as PIL refuses it."""
    rng = np.random.default_rng(len(suffix))
    for h, w in JPEG_SIZES:
        for shape in ((h, w), (h, w, 3)):
            for a in (rng.integers(0, 256, shape).astype(np.uint8),
                      _picture(w, h, 3, h)[..., :shape[-1]].reshape(shape)
                      if len(shape) == 3 else _picture(w, h, 1, w)[..., 0]):
                ours, theirs = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
                tio.save_image(ours, a)
                Image.fromarray(a).save(theirs)
                assert ours.read_bytes() == theirs.read_bytes(), (shape,
                                                                  suffix)
    with pytest.raises(ValueError, match="RGBA"):
        tio.save_image(tmp_path / f"c{suffix}", np.zeros((4, 4, 4), np.uint8))
    assert not (tmp_path / f"c{suffix}").exists()
    with pytest.raises(OSError, match="RGBA"):
        Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(
            tmp_path / f"d{suffix}")


@pytest.mark.parametrize("suffix", [".qoi", ".sgi", ".rgb", ".rgba", ".bw",
                                    ".pcx", ".pbm", ".Sgi"])
def test_save_image_writes_the_others_as_pil(tmp_path, suffix):
    """QOI, SGI (the file's stem in its header), PCX and PBM byte for byte
    as PIL's save; what PIL refuses to write raises and writes nothing."""
    rng = np.random.default_rng(len(suffix) + 3)
    for shape in ((1, 1), (9, 13), (9, 13, 3), (9, 13, 4), (1, 7, 3),
                  (6, 130, 4)):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        flat = _flat_picture(shape[1], shape[0], 4, 1)[..., :shape[2]] \
            if len(shape) == 3 else _flat_picture(shape[1], shape[0], 1,
                                                  1)[..., 0]
        for arr in (a, flat):
            ours = tmp_path / f"one{suffix}"
            theirs = tmp_path / "other" / f"one{suffix}"
            theirs.parent.mkdir(exist_ok=True)
            ours.unlink(missing_ok=True)
            try:
                Image.fromarray(arr).save(theirs)
            except (ValueError, OSError):
                with pytest.raises(ValueError):
                    tio.save_image(ours, arr)
                assert not ours.exists()
                continue
            tio.save_image(ours, arr)
            assert ours.read_bytes() == theirs.read_bytes(), (shape, suffix)
            np.testing.assert_array_equal(tio.load_image(ours),
                                          _pil(ours.read_bytes()))


def test_courtyard_jpeg_digests_are_pils():
    """The courtyard's four RGB maps written by save_image as JPEG: the
    SHA-256 digests chip_smoke.py checks on the card's machine (which has
    no PIL) are those of PIL's save of the same arrays."""
    import chip_smoke

    for stem, digest in chip_smoke.COURTYARD_JPEG_SHA256.items():
        a = tio.load_image(DEMO / f"{stem}.png")[..., :3]
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG")
        assert hashlib.sha256(buf.getvalue()).hexdigest() == digest, stem
        assert jpeg_encode.encode_jpeg(a) == buf.getvalue(), stem


def test_other_formats_still_name_themselves(tmp_path):
    """Formats PIL reads and writes that the port does not (ROADMAP.md
    lists them): load_image and save_image name the format. IM, XBM, MSP
    and ICNS, which this test named until slice 18, are read now, and so
    is JPEG 2000 (.jp2, .j2k: PIL's decode, bit for bit), which it named
    until slice 20, and AVIF (PIL's decode, bit for bit, through
    assets/avif.py); GIF, ICO, ICNS, EPS / PS, PDF and MPO are written
    since slice 21 (tests/test_torch_formats_writers.py), JPEG 2000
    since slice 22 (tests/test_torch_formats_j2k_write.py) and AVIF since
    slice 26 (tests/test_torch_formats_avif_write.py); the writers PIL
    runs for the suffixes left need codecs the port lacks, refuse L, RGB
    and RGBA themselves or have no handler here (BUFR, GRIB, WMF)."""
    rgb = np.zeros((4, 4, 3), np.uint8)
    for name, fmt in (("a.jp2", None), ("a.j2k", None), ("a.avif", None)):
        Image.fromarray(rgb).save(tmp_path / name)
        if fmt is None:
            np.testing.assert_array_equal(
                tio.load_image(tmp_path / name),
                _pil((tmp_path / name).read_bytes()))
            continue
        with pytest.raises(ValueError, match=fmt):
            tio.load_image(tmp_path / name)
    for suffix, fmt in ((".bufr", "BUFR"),
                        (".wmf", "WMF"), (".grib", "GRIB"),
                        (".blp", "BLP"), (".msp", "MSP"), (".xbm", "XBM"),
                        (".palm", "PALM")):
        with pytest.raises(ValueError, match=f"does not write {fmt}"):
            tio.save_image(tmp_path / f"b{suffix}", rgb)
        assert not (tmp_path / f"b{suffix}").exists()


# ------------------------ the slice against JAX ----------------------

def _map_files(tmp_path, fmt):
    """The ivy material's three maps at 48 x 48 written as `fmt`: by PIL
    where it writes the format, else built here."""
    out = {}
    for slot, name in (("albedo", "ivy_albedo"), ("normal", "ivy_normal"),
                       ("specular", "ivy_mr")):
        im = Image.open(DEMO / f"{name}.png").resize((48, 48))
        a = np.asarray(im)
        p = tmp_path / f"{name}.{fmt.split('_')[0]}"
        if fmt == "psd":
            c = a.shape[2]
            p.write_bytes(_psd(3, 8, a.transpose(2, 0, 1), 1, n_channels=c))
        elif fmt == "cur":
            p.write_bytes(_icon_dir(b"\0\0\2\0", [(48, 48, 0, 32, _dib(
                np.asarray(im.convert("RGBA")), 32))]))
        elif fmt == "sgi_rle":
            p.write_bytes(_sgi_rle(a.astype(np.int64), 1, 3))
        elif fmt == "tif_ycbcr_jpeg":
            tables, stream = _jpeg_tiff_parts(a[..., :3], 2)
            p.write_bytes(_tiff_file(48, 48, [stream], {
                258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]),
                277: (3, [3]), 278: (4, [48]), 347: tables,
                530: (3, [2, 2])}))
        else:
            kind, kw = {"qoi": ("QOI", {}), "sgi": ("SGI", {}),
                        "pcx": ("PCX", {}), "ico": ("ICO", {}),
                        "dib": ("DIB", {}),
                        "tif_jpeg": ("TIFF", {"compression": "jpeg"}),
                        "tif_cmyk": ("TIFF", {}),
                        "tif_float": ("TIFF", {"big_tiff": True})}[fmt]
            src = {"pcx": im.convert("RGB"), "dib": im.convert("RGB"),
                   "tif_jpeg": im.convert("RGB"), "tif_cmyk":
                   im.convert("CMYK"),
                   "tif_float": im.convert("L").convert("F")}.get(
                fmt, im)
            src.save(p, kind, **kw)
        out[slot] = str(p)
    return types.SimpleNamespace(**out)


@pytest.mark.parametrize("fmt", ["qoi", "sgi", "sgi_rle", "pcx", "ico",
                                 "cur", "dib", "psd", "tif_jpeg", "tif_cmyk",
                                 "tif_float", "tif_ycbcr_jpeg"])
def test_texture_images_match_jax(tmp_path, fmt):
    """render/scenebuild._load_texture_images on a mesh whose three maps
    are in `fmt`: an image in every slot, equal to the JAX package's."""
    paths = _map_files(tmp_path, fmt)
    got, want = tsb._load_texture_images(paths), \
        jsb._load_texture_images(paths)
    for slot in ("albedo", "normal", "specular"):
        g, w = getattr(got, slot), getattr(want, slot)
        assert w is not None and g is not None, (fmt, slot)
        np.testing.assert_array_equal(g, w, err_msg=f"{fmt} {slot}")


# ------------------------------ fixtures -----------------------------

def more_fixture_files() -> dict:
    """name -> bytes of the fixtures this slice adds to tests/data/formats
    (test_torch_formats.write_fixtures writes them with the others)."""
    rgb = _picture(32, 24, 3, 21)
    rgba = _picture(32, 24, 4, 22)
    flat = _flat_picture(32, 24, 4, 23)
    rng = np.random.default_rng(17)
    out = {}
    img = Image.fromarray(rgb)
    out["rgba.qoi"] = _save(Image.fromarray(flat), "QOI")
    out["rgb.sgi"] = _save(img, "SGI")
    out["rgba16.sgi"] = _save(Image.fromarray(rgba), "SGI", bpc=2)
    out["rgba_rle.sgi"] = _sgi_rle(flat.astype(np.int64), 1, 3)
    out["rgb.pcx"] = _save(Image.fromarray(flat[..., :3]), "PCX")
    out["pal8.pcx"] = _save(img.quantize(40), "PCX")
    idx = rng.integers(0, 16, (24, 30))
    out["pal4_planes.pcx"] = _pcx(30, 24, 5, 1, 4, _planar_lines(idx, 4, 4),
                                  4, rng.integers(0, 256, 48).astype(
                                      np.uint8).tobytes())
    page = _save(img.convert("L"), "PCX")
    out["grey.dcx"] = struct.pack("<II", 987654321, 12) + bytes(4) + page
    out["rgba.ico"] = _save(Image.fromarray(rgba), "ICO", sizes=[(32, 24)])
    mask = (rng.random((24, 32)) < 0.3).astype(np.uint8)
    out["pal8_mask.ico"] = _icon_dir(b"\0\0\1\0", [(32, 24, 0, 8, _dib(
        rng.integers(0, 16, (24, 32)), 8, rng.integers(0, 256, (16, 3)),
        mask))])
    out["rgba32.cur"] = _icon_dir(b"\0\0\2\0", [(32, 24, 0, 32,
                                                 _dib(rgba, 32))])
    out["rgb24.dib"] = _save(img, "DIB")
    out["rgba_packbits.psd"] = _psd(3, 8, flat.transpose(2, 0, 1), 1)
    out["cmyk_raw.psd"] = _psd(4, 8, rgba.transpose(2, 0, 1), 0)
    out["rgb_jpeg.tif"] = _save(img, "TIFF", compression="jpeg")
    tables, stream = _jpeg_tiff_parts(rgb, 2)
    out["ycbcr_jpeg.tif"] = _tiff_file(32, 24, [stream], {
        258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
        278: (4, [24]), 347: tables, 530: (3, [2, 2])})
    ycc = rng.integers(0, 256, (24, 32, 3))
    out["ycbcr_lzw.tif"] = _save(Image.fromarray(rgb).convert("YCbCr"),
                                   "TIFF", compression="tiff_lzw")
    out["ycbcr21_deflate.tif"] = _tiff_file(32, 24, [zlib.compress(
        _ycbcr_units(ycc, 2, 1))], {258: (3, [8, 8, 8]), 259: (3, [8]),
                                    262: (3, [6]), 277: (3, [3]),
                                    278: (4, [24]), 530: (3, [2, 1])})
    out["cmyk_lzw.tif"] = _save(img.convert("CMYK"), "TIFF",
                                compression="tiff_lzw")
    f = rng.normal(120, 90, (24, 32)).astype(np.float32)
    out["float_pred3.tif"] = _save(Image.fromarray(f, "F"), "TIFF",
                                   compression="tiff_adobe_deflate",
                                   tiffinfo={317: 3})
    out["bigtiff_rgb.tif"] = _save(img, "TIFF", big_tiff=True,
                                   compression="tiff_lzw")
    out["orient6.tif"] = _save(img, "TIFF", tiffinfo={274: 6})
    return out


if __name__ == "__main__":
    sys.exit("run with pytest; the fixtures are written by "
             "tests/test_torch_formats.py --write-fixtures")
