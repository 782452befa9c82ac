"""The writers save_image gained for GIF, ICO, ICNS, EPS / PS, PDF and MPO,
and the modules under them (assets/resample.py, quantize.py, lzw.py's GIF
encoder, gif.py, ico.py, icns.py, eps.py, pdf.py), against PIL, which the
JAX package's save_image uses:

  - the resampler equals ``Image.resize`` (BICUBIC, LANCZOS) and
    ``Image.thumbnail`` for L, RGB and RGBA, up and down, sizes of 1;
  - the quantisers equal ``convert("P", palette=ADAPTIVE)``, palette and
    indices: median cut for RGB (one image with more than 65536 colours,
    where PIL's hash table coarsens), fast octree for RGBA;
  - GIF, EPS, PS, PDF (with ``time.gmtime`` frozen on both sides; RGBA
    as PIL's JPEG 2000 image) and MPO byte for byte PIL's save, for 1 x 1
    and 9 x 13 L / RGB / RGBA and an image wider than 256 pixels; what PIL
    refuses raises ValueError and writes no file;
  - ICO and ICNS entry for entry: the same directory fields, and each
    embedded PNG decoded equal to PIL's (the PNG bytes differ: the port
    deflates with Python's zlib);
  - the digests chip_smoke.py holds the writers to on the card's machine
    (which has no PIL) are those of PIL's saves.

Numpy and PIL on small images; no frame is rendered.
"""

import hashlib
import io
import struct
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from plainrenderer_tpu_torch.assets import gif, lzw, quantize, resample
from plainrenderer_tpu_torch.assets import image_io as tio
from test_torch_formats import _picture

FILTERS = {"bicubic": Image.Resampling.BICUBIC,
           "lanczos": Image.Resampling.LANCZOS}
CLOCK = time.gmtime(1_700_000_000)


def _image(shape, seed):
    """A gradient-and-noise picture of `shape` ((H, W) or (H, W, c)); RGBA
    with a fifth of its pixels transparent and some half transparent."""
    h, w = shape[:2]
    c = shape[2] if len(shape) == 3 else 1
    a = _picture(w, h, c, seed)
    if c == 4:
        rng = np.random.default_rng(seed)
        a[..., 3] = rng.choice([0, 255, 255, 128, 7], (h, w))
    return a[..., 0] if c == 1 else a


# ----------------------------- resampling ----------------------------

@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_equals_pil(name, channels):
    for k, (shape, sizes) in enumerate((
            ((9, 13), [(1, 1), (5, 3), (26, 18), (13, 40)]),
            ((1, 1), [(3, 2), (1, 1)]),
            ((40, 70), [(16, 16), (69, 41), (7, 40), (256, 256)]))):
        a = _image(shape + ((channels,) if channels > 1 else ()), k)
        for size in sizes:
            want = np.asarray(Image.fromarray(a).resize(size, FILTERS[name]))
            np.testing.assert_array_equal(resample.resize(a, size, name),
                                          want, err_msg=f"{shape} {size}")


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_thumbnail_equals_pil(channels):
    for k, shape in enumerate(((9, 13), (1, 1), (300, 17), (40, 33))):
        a = _image(shape + ((channels,) if channels > 1 else ()), k)
        for size in ((16, 16), (1, 1), (24, 24), (300, 300), (5, 64)):
            im = Image.fromarray(a)
            im.thumbnail(size, Image.Resampling.LANCZOS, reducing_gap=None)
            got = resample.thumbnail(a, size, "lanczos")
            np.testing.assert_array_equal(got, np.asarray(im),
                                          err_msg=f"{shape} {size}")


# ----------------------------- quantising ----------------------------

def _adaptive(a):
    im = Image.fromarray(a).convert("P", palette=Image.Palette.ADAPTIVE)
    return np.asarray(im), im


@pytest.mark.parametrize("case", ["tiny", "one", "few", "many", "flat",
                                  "over_65536"])
def test_median_cut_equals_pil(case):
    rng = np.random.default_rng(len(case))
    a = {"tiny": lambda: rng.integers(0, 256, (9, 13, 3)),
         "one": lambda: rng.integers(0, 256, (1, 1, 3)),
         "few": lambda: rng.integers(0, 4, (30, 40, 3)) * 60,
         "many": lambda: _picture(80, 64, 3, 5),
         "flat": lambda: np.full((20, 20, 3), 77),
         "over_65536": lambda: rng.integers(0, 256, (300, 240, 3))}[case]()
    a = a.astype(np.uint8)
    want_idx, im = _adaptive(a)
    idx, pal = quantize.median_cut(a)
    assert pal.tobytes() == bytes(im.getpalette())
    np.testing.assert_array_equal(idx.reshape(a.shape[:2]), want_idx)


@pytest.mark.parametrize("case", ["tiny", "one", "many", "opaque",
                                  "large"])
def test_fast_octree_equals_pil(case):
    rng = np.random.default_rng(10 + len(case))
    shape = {"tiny": (9, 13), "one": (1, 1), "many": (64, 80),
             "opaque": (33, 40), "large": (300, 280)}[case]
    a = rng.integers(0, 256, shape + (4,)).astype(np.uint8)
    if case == "many":
        a = _image(shape + (4,), 3)
    if case == "opaque":
        a[..., 3] = 255
    want_idx, im = _adaptive(a)
    idx, pal = quantize.fast_octree(a)
    assert im.palette.mode == "RGBA"
    assert pal.tobytes() == bytes(im.getpalette(None))
    np.testing.assert_array_equal(idx.reshape(a.shape[:2]), want_idx)


def test_gif_lzw_round_trips_and_resets_its_table():
    """The encoder's codes decode back (the table fills and resets on a
    long random run), and a long run of one value packs as PIL's does."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 20000).astype(np.uint8).tobytes()
    packed = lzw.encode_gif(data)
    assert lzw.decode_gif(packed, 8, len(data)) == data
    assert lzw.decode_gif(lzw.encode_gif(b""), 8, 10) == b""
    for a in (np.zeros((200, 200), np.uint8),
              rng.integers(0, 3, (400, 400)).astype(np.uint8)):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "GIF")
        assert gif.encode_gif(a) == buf.getvalue()


# ------------------------------ writers ------------------------------

SHAPES = [(1, 1), (1, 1, 3), (1, 1, 4), (9, 13), (9, 13, 3), (9, 13, 4),
          (12, 300), (12, 300, 3), (12, 300, 4)]


def _pil_save(path, a):
    """PIL's save to `path`, or the exception it raises."""
    try:
        Image.fromarray(a).save(path)
        return path.read_bytes()
    except Exception as e:  # noqa: BLE001 - any refusal of PIL's
        return e


@pytest.mark.parametrize("suffix", [".gif", ".eps", ".ps", ".pdf", ".mpo"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_save_image_byte_for_byte(tmp_path, monkeypatch, suffix, shape):
    monkeypatch.setattr(time, "gmtime", lambda *a: CLOCK)
    a = _image(shape, len(shape) + shape[1])
    want = _pil_save(tmp_path / f"pil{suffix}", a)
    ours = tmp_path / f"pil_{suffix[1:]}" / f"pil{suffix}"  # same stem
    ours.parent.mkdir()
    if isinstance(want, Exception):
        with pytest.raises(ValueError, match="RGBA|mode"):
            tio.save_image(ours, a)
        assert not ours.exists()
        return
    tio.save_image(ours, a)
    assert ours.read_bytes() == want


def test_pdf_rgba_names_jpeg_2000(tmp_path, monkeypatch):
    """PIL writes RGBA as JPEG 2000 (JPXDecode); so does the port, byte
    for byte at a frozen clock."""
    monkeypatch.setattr(time, "gmtime", lambda *a: CLOCK)
    a = _image((9, 13, 4), 1)
    Image.fromarray(a).save(tmp_path / "pil.pdf")
    want = (tmp_path / "pil.pdf").read_bytes()
    assert b"/JPXDecode" in want
    (tmp_path / "port").mkdir()
    tio.save_image(tmp_path / "port" / "pil.pdf", a)
    assert (tmp_path / "port" / "pil.pdf").read_bytes() == want


def _pil_rgba(png: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(png)) as im:
        return np.asarray(im.convert("RGBA"))


def _ico_entries(data: bytes):
    (n,) = struct.unpack_from("<H", data, 4)
    out = []
    for i in range(n):
        d = data[6 + 16 * i:22 + 16 * i]
        size, offset = struct.unpack_from("<II", d, 8)
        png = data[offset:offset + size]
        with Image.open(io.BytesIO(png)) as im:
            out.append((d[:8], im.mode, np.asarray(im)))
    return data[:6], out


@pytest.mark.parametrize("shape", [(1, 1), (9, 13, 3), (40, 33),
                                   (12, 300, 3), (300, 270, 4)], ids=str)
def test_ico_entries_equal_pil(tmp_path, shape):
    a = _image(shape, 3)
    Image.fromarray(a).save(tmp_path / "pil.ico")
    tio.save_image(tmp_path / "port.ico", a)
    want = _ico_entries((tmp_path / "pil.ico").read_bytes())
    got = _ico_entries((tmp_path / "port.ico").read_bytes())
    assert got[0] == want[0] and len(got[1]) == len(want[1])
    for (gd, gm, gp), (wd, wm, wp) in zip(got[1], want[1]):
        assert gd == wd and gm == wm
        np.testing.assert_array_equal(gp, wp)
    if want[1]:  # PIL opens no ICO without entries (images under 16 px)
        with Image.open(tmp_path / "pil.ico") as x, \
                Image.open(tmp_path / "port.ico") as y:
            np.testing.assert_array_equal(np.asarray(x.convert("RGBA")),
                                          np.asarray(y.convert("RGBA")))


def _icns_entries(data: bytes):
    (total,) = struct.unpack_from(">i", data, 4)
    out, at = [], 8
    while at < total:
        kind, size = struct.unpack_from(">4si", data, at)
        body = data[at + 8:at + size]
        if kind == b"TOC ":
            out.append((kind, [body[i:i + 4] for i in range(0, len(body), 8)]))
        else:
            with Image.open(io.BytesIO(body)) as im:
                out.append((kind, im.mode, np.asarray(im)))
        at += size
    return out


@pytest.mark.parametrize("shape", [(1, 1), (9, 13, 3), (40, 33, 4)],
                         ids=str)
def test_icns_entries_equal_pil(tmp_path, shape):
    a = _image(shape, 4)
    Image.fromarray(a).save(tmp_path / "pil.icns")
    tio.save_image(tmp_path / "port.icns", a)
    want = _icns_entries((tmp_path / "pil.icns").read_bytes())
    got = _icns_entries((tmp_path / "port.icns").read_bytes())
    assert [e[0] for e in got] == [e[0] for e in want]
    assert got[0] == want[0]  # the TOC's types
    for g, w in zip(got[1:], want[1:]):
        assert g[1] == w[1], g[0]
        np.testing.assert_array_equal(g[2], w[2], err_msg=str(g[0]))


def test_refused_modes_write_nothing(tmp_path):
    rgba = _image((9, 13, 4), 2)
    for suffix in (".eps", ".ps", ".pcx", ".mpo"):
        assert isinstance(_pil_save(tmp_path / f"pil{suffix}", rgba),
                          Exception)
        with pytest.raises(ValueError):
            tio.save_image(tmp_path / f"port{suffix}", rgba)
        assert not (tmp_path / f"port{suffix}").exists()


# -------------------------- chip_smoke digests ------------------------

def pil_writer_digests() -> dict:
    """What PIL's save of chip_smoke.writer_image gives for each suffix and
    mode it writes (PDF at chip_smoke's clock): the file's SHA-256, or for
    ICO and ICNS chip_smoke.icon_digest over PIL's own decode."""
    import chip_smoke

    out = {}
    clock = time.gmtime(chip_smoke.WRITER_CLOCK)
    with tempfile.TemporaryDirectory() as tmp:
        for suffix in chip_smoke.WRITER_SIZES:
            for mode in ("L", "RGB", "RGBA"):
                if mode in chip_smoke.WRITER_REFUSED.get(suffix, ()):
                    continue
                path = Path(tmp) / f"writer_{mode.lower()}{suffix}"
                with mock.patch.object(time, "gmtime", lambda *a: clock):
                    Image.fromarray(chip_smoke.writer_image(
                        suffix, mode)).save(path)
                data = path.read_bytes()
                out[f"{suffix} {mode}"] = (
                    chip_smoke.icon_digest(data, _pil_rgba)
                    if suffix in (".ico", ".icns")
                    else hashlib.sha256(data).hexdigest())
    return out


def test_chip_smoke_writer_digests_are_pils(tmp_path):
    """chip_smoke.WRITER_SHA256, which the card's machine holds save_image
    to, is PIL's; the refused modes are the ones PIL refuses."""
    import chip_smoke

    assert chip_smoke.WRITER_SHA256 == pil_writer_digests()
    for suffix, modes in chip_smoke.WRITER_REFUSED.items():
        for mode in modes:
            img = chip_smoke.writer_image(suffix, mode)
            refused = isinstance(_pil_save(tmp_path / f"a{suffix}", img),
                                 Exception)
            assert refused, (suffix, mode)
