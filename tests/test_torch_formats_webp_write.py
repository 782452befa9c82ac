"""WebP writing in the port (assets/webp_encode.py over webp_picture.py,
vp8_encode.py and vp8l_encode.py) against the JAX package's save_image,
which is PIL 12.1's default lossy save through its bundled libwebp 1.6.0:

  - save_image byte for byte: L, RGB, opaque RGBA and RGBA with
    transparency at 1 x 1, 7 x 13, 17 x 33 and 96 x 128, each as seeded
    noise, gradients and a flat colour (all-skip macroblocks); alpha with
    fully transparent squares (the clean-up of the picture under them),
    with 5 values (a palette, no filter), with 256 values where a filter
    wins, and seeded noise (kept raw); the courtyard's ivy_albedo.png;
    upper-case suffixes; every file read back by the port's load_image as
    PIL decodes it;
  - each stage alone against libwebp through ctypes (PIL's bundled
    library): the YUV 4:2:0 and alpha planes of WebPPictureARGBToYUVA
    before and after WebPCleanupTransparentArea, the segment quantisers
    and filter levels WebPAuxStats reports, and the lossless alpha
    stream (a lossless WebPEncode of the plane in green at method 4,
    quality 32, exact: the stream after its 5-byte header);
  - what PIL refuses (a side above 16383) raises ValueError and writes
    nothing.

``PYTHONPATH=. python tests/test_torch_formats_webp_write.py`` holds all 12
courtyard textures against PIL's saves and prints their SHA-256 (the
digests chip_smoke.py holds the port to, COURTYARD_WEBP_WRITTEN_SHA256)
with the host time of each encode. One thread, no card."""

import ctypes
import glob
import hashlib
import io
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu_torch.assets import (vp8_encode, vp8l_encode,
                                            webp_encode, webp_picture)
from plainrenderer_tpu_torch.assets import image_io as tio

torch.set_num_threads(1)
DEMO = Path(__file__).resolve().parent.parent / "assets" / "demo"
SHAPES = [(1, 1), (7, 13), (17, 33), (96, 128)]
MODES = ["L", "RGB", "RGBA opaque", "RGBA"]
KINDS = ["noise", "gradient", "flat"]


def _content(kind, shape, mode, seed=0):
    h, w = shape
    c = {"L": 1, "RGB": 3}.get(mode, 4)
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "noise":
        a = rng.integers(0, 256, (h, w, c))
    elif kind == "gradient":
        a = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                      (x + y) * 3 % 256, 255 - (x * y) % 200][:c], -1)
    else:
        a = np.broadcast_to(np.array([200, 30, 90, 140][:c]), (h, w, c))
    a = np.array(a, np.uint8)
    if mode == "RGBA opaque":
        a[..., 3] = 255
    elif mode == "RGBA":
        a[..., 3][rng.random((h, w)) < 0.3] = 0
    return a[..., 0] if c == 1 else a


def _alpha_case(name, shape=(96, 128), seed=1):
    h, w = shape
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.clip(np.stack([x * 2, y * 2, (x + y) % 256], -1)
                  + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
    alpha = {"holes": np.where((y // 16 + x // 16) % 2 == 0, 0, 255),
             "few": rng.integers(0, 5, (h, w)) * 60,
             "filtered": np.clip(x * 2 + rng.integers(0, 3, (h, w)), 0, 255),
             "noise": rng.integers(0, 256, (h, w))}[name]
    return np.concatenate([rgb, alpha.astype(np.uint8)[..., None]], -1)


def _pil_rgba(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def _check_save(tmp_path, a, name="a.webp"):
    """The port's file equals the JAX package's, and reads back through
    the port's load_image as PIL reads it."""
    ours, theirs = tmp_path / f"ours_{name}", tmp_path / f"pil_{name}"
    tio.save_image(ours, a)
    jio.save_image(theirs, a)
    data = ours.read_bytes()
    assert data == theirs.read_bytes()
    np.testing.assert_array_equal(tio.load_image(ours), _pil_rgba(data))
    return data


def _chunks(data: bytes) -> dict:
    out, pos = {}, 12
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos + 4:pos + 8], "little")
        out[data[pos:pos + 4]] = data[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)
    return out


# ---------------------------------------------------- libwebp via ctypes

def _libwebp():
    libs = Path(Image.__file__).resolve().parent.parent / "pillow.libs"
    for dep in glob.glob(str(libs / "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    found = glob.glob(str(libs / "libwebp-*.so*"))
    if not found:
        pytest.skip("PIL has no bundled libwebp here")
    return ctypes.CDLL(found[0])


_ABI = 0x020F
_INTS = ("segments sns_strength filter_strength filter_sharpness "
         "filter_type autofilter alpha_compression alpha_filtering "
         "alpha_quality pass show_compressed preprocessing partitions "
         "partition_limit emulate_jpeg_size thread_level low_memory "
         "near_lossless exact use_delta_palette use_sharp_yuv qmin qmax")


class _Config(ctypes.Structure):  # src/webp/encode.h WebPConfig
    _fields_ = ([("lossless", ctypes.c_int), ("quality", ctypes.c_float),
                 ("method", ctypes.c_int), ("image_hint", ctypes.c_int),
                 ("target_size", ctypes.c_int),
                 ("target_PSNR", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in _INTS.split()])


class _Stats(ctypes.Structure):  # WebPAuxStats
    _fields_ = ([("coded_size", ctypes.c_int),
                 ("PSNR", ctypes.c_float * 5),
                 ("block_count", ctypes.c_int * 3),
                 ("header_bytes", ctypes.c_int * 2),
                 ("residual_bytes", ctypes.c_int * 12),
                 ("segment_size", ctypes.c_int * 4),
                 ("segment_quant", ctypes.c_int * 4),
                 ("segment_level", ctypes.c_int * 4),
                 ("alpha_data_size", ctypes.c_int),
                 ("layer_data_size", ctypes.c_int),
                 ("lossless_features", ctypes.c_uint32)]
                + [(n, ctypes.c_int) for n in (
                    "histogram_bits transform_bits cache_bits palette_size "
                    "lossless_size lossless_hdr_size "
                    "lossless_data_size").split()]
                + [("pad", ctypes.c_uint32 * 2)])


_WRITER = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                           ctypes.c_size_t, ctypes.c_void_p)
_P = ctypes.POINTER(ctypes.c_uint8)


class _Picture(ctypes.Structure):  # WebPPicture
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", _P), ("u", _P), ("v", _P), ("y_stride", ctypes.c_int),
                ("uv_stride", ctypes.c_int), ("a", _P),
                ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
                ("argb", ctypes.POINTER(ctypes.c_uint32)),
                ("argb_stride", ctypes.c_int),
                ("pad2", ctypes.c_uint32 * 3), ("writer", _WRITER),
                ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", _P),
                ("stats", ctypes.POINTER(_Stats)),
                ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p),
                ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p),
                ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2)]


@pytest.fixture(scope="module")
def libwebp():
    lib = _libwebp()
    pic, cfg = ctypes.POINTER(_Picture), ctypes.POINTER(_Config)
    lib.WebPPictureInitInternal.argtypes = [pic, ctypes.c_int]
    lib.WebPConfigInitInternal.argtypes = [cfg, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int]
    lib.WebPPictureAlloc.argtypes = [pic]
    lib.WebPPictureFree.argtypes = [pic]
    lib.WebPPictureARGBToYUVA.argtypes = [pic, ctypes.c_int]
    lib.WebPCleanupTransparentArea.argtypes = [pic]
    lib.WebPEncode.argtypes = [cfg, pic]
    return lib


def _argb_picture(lib, rgba):
    """An ARGB picture as Pillow's _webp.c fills it."""
    h, w = rgba.shape[:2]
    px = rgba.astype(np.uint32)
    argb = (px[..., 3] << 24) | (px[..., 0] << 16) | (px[..., 1] << 8) \
        | px[..., 2]
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI)
    pic.width, pic.height, pic.use_argb = w, h, 1
    assert lib.WebPPictureAlloc(ctypes.byref(pic))
    base = ctypes.addressof(pic.argb.contents)
    for y in range(h):
        ctypes.memmove(base + 4 * pic.argb_stride * y,
                       np.ascontiguousarray(argb[y]).tobytes(), 4 * w)
    return pic


def _plane(ptr, stride, h, w):
    buf = ctypes.string_at(ptr, stride * (h - 1) + w)
    return np.array([np.frombuffer(buf[r * stride:r * stride + w], np.uint8)
                     for r in range(h)])


def _lib_yuva(lib, rgba, cleanup):
    pic = _argb_picture(lib, rgba)
    assert lib.WebPPictureARGBToYUVA(ctypes.byref(pic), 0)
    if cleanup:
        lib.WebPCleanupTransparentArea(ctypes.byref(pic))
    h, w = rgba.shape[:2]
    uh, uw = (h + 1) // 2, (w + 1) // 2
    out = (_plane(pic.y, pic.y_stride, h, w),
           _plane(pic.u, pic.uv_stride, uh, uw),
           _plane(pic.v, pic.uv_stride, uh, uw),
           _plane(pic.a, pic.a_stride, h, w) if bool(pic.a) else None)
    lib.WebPPictureFree(ctypes.byref(pic))
    return out


def _lib_encode(lib, rgba, **settings):
    """WebPEncode at Pillow's settings (or as overridden): (bytes,
    WebPAuxStats)."""
    cfg = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, 75.0, _ABI)
    cfg.quality, cfg.alpha_quality, cfg.method, cfg.exact = 80.0, 100, 4, 0
    for k, v in settings.items():
        setattr(cfg, k, v)
    pic = _argb_picture(lib, rgba)
    out = bytearray()

    @_WRITER
    def writer(data, size, _):
        out.extend(ctypes.string_at(data, size))
        return 1
    pic.writer = writer
    stats = _Stats()
    pic.stats = ctypes.pointer(stats)
    assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    lib.WebPPictureFree(ctypes.byref(pic))
    return bytes(out), stats


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_save_image_webp_equals_jax(tmp_path, shape, mode, kind):
    a = _content(kind, shape, mode, seed=shape[0] * 7 + shape[1])
    data = _check_save(tmp_path, a)
    has_alpha = mode == "RGBA" and (a[..., 3] != 255).any()
    assert (b"ALPH" in _chunks(data)) == has_alpha
    if mode == "RGBA opaque":  # the same file as its RGB image
        jio.save_image(tmp_path / "rgb.webp", a[..., :3])
        assert data == (tmp_path / "rgb.webp").read_bytes()


@pytest.mark.parametrize("name,header", [("holes", 0x01), ("few", 0x01),
                                         ("filtered", 0x05),
                                         ("noise", 0x00)])
def test_webp_alpha_planes(tmp_path, name, header):
    """Transparent squares (the clean-up), 5 values (palette, no filter),
    256 values where the horizontal filter wins, noise (kept raw)."""
    data = _check_save(tmp_path, _alpha_case(name))
    assert _chunks(data)[b"ALPH"][0] == header


def test_webp_ivy_albedo(tmp_path):
    with Image.open(DEMO / "ivy_albedo.png") as im:
        a = np.asarray(im.convert("RGBA"))
    data = _check_save(tmp_path, a, "ivy.webp")
    assert _chunks(data)[b"ALPH"][0] == 0x01


def test_webp_suffix_case_and_refusals(tmp_path):
    a = _content("gradient", (17, 33), "RGB")
    _check_save(tmp_path, a, "b.WebP")
    for shape in ((1, 16384), (16384, 1)):
        big = np.zeros(shape + (3,), np.uint8)
        with pytest.raises(ValueError, match="16383"):
            tio.save_image(tmp_path / "big.webp", big)
        assert not (tmp_path / "big.webp").exists()
        with pytest.raises((OSError, ValueError)):
            jio.save_image(tmp_path / "pil_big.webp", big)


@pytest.mark.parametrize("name", ["noise", "holes", "odd"])
def test_webp_picture_planes_equal_libwebp(libwebp, name):
    """WebPPictureARGBToYUVA (gamma-compressed, alpha-weighted chroma, odd
    edges) and WebPCleanupTransparentArea on its planes."""
    rng = np.random.default_rng(5)
    shape = (17, 33) if name == "odd" else (40, 56)
    a = rng.integers(0, 256, shape + (4,), np.uint8)
    if name == "holes":
        a[8:24, 8:40, 3] = 0
        a[..., 3][rng.random(shape) < 0.2] = 0
    for cleanup in (False, True):
        y, u, v, al = webp_picture.to_yuva(a)
        if cleanup:
            webp_picture.cleanup_transparent(y, u, v, al)
        want = _lib_yuva(libwebp, a, cleanup)
        for got, ref in zip((y, u, v, al), want):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["noise", "gradient", "flat"])
def test_vp8_segments_equal_libwebp(libwebp, kind):
    """The segment quantisers and filter levels WebPAuxStats reports."""
    a = _content(kind, (96, 128), "RGB", seed=3)
    _, stats = _lib_encode(libwebp, np.concatenate(
        [a, np.full(a.shape[:2] + (1,), 255, np.uint8)], -1))
    y, u, v, _ = webp_picture.to_yuva(webp_picture.as_rgba(a))
    enc = vp8_encode.Encoder(y, u, v, a.shape[1], a.shape[0])
    enc.encode()
    assert [s.quant for s in enc.segments] == list(stats.segment_quant)
    assert [s.fstrength for s in enc.segments] == list(stats.segment_level)


@pytest.mark.parametrize("name", ["holes", "few", "filtered", "smooth"])
def test_vp8l_alpha_stream_equals_libwebp(libwebp, name):
    """The plane in green, lossless at method 4, quality 32, exact: the
    stream after the VP8L chunk's 5-byte header is EncodeAlpha's."""
    if name == "smooth":
        rng = np.random.default_rng(2)
        plane = np.clip(np.cumsum(np.cumsum(rng.normal(0, 1, (96, 128)), 0),
                                  1) + 128, 0, 255).astype(np.uint8)
    else:
        plane = _alpha_case(name)[..., 3]
    green = np.zeros(plane.shape + (4,), np.uint8)
    green[..., 1] = plane
    data, _ = _lib_encode(libwebp, green, lossless=1, quality=32.0,
                          exact=1)
    assert vp8l_encode.encode_alpha_stream(plane) == \
        _chunks(data)[b"VP8L"][5:]


def test_courtyard_webp_digests_are_pils():
    """chip_smoke.COURTYARD_WEBP_WRITTEN_SHA256, which the card's machine
    holds the port's WebP saves of the courtyard to, is PIL's (the port
    writes them: ivy_albedo above, all 12 in this file's __main__ run and
    on the card's machine)."""
    import chip_smoke

    want = {}
    for stem, a in courtyard_textures().items():
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "WEBP")
        want[stem] = hashlib.sha256(buf.getvalue()).hexdigest()
    assert chip_smoke.COURTYARD_WEBP_WRITTEN_SHA256 == want


def courtyard_textures():
    """The 12 courtyard textures as the App's copies hold them: RGBA, the
    RGB normal maps kept RGB."""
    out = {}
    for p in sorted(DEMO.glob("*.png")):
        with Image.open(p) as im:
            a = np.asarray(im.convert("RGBA"))
        out[p.stem] = a[..., :3] if (a[..., 3] == 255).all() and \
            "normal" in p.stem else a
    return out


if __name__ == "__main__":
    for stem, a in courtyard_textures().items():
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "WEBP")
        t0 = time.perf_counter()
        ours = webp_encode.encode_webp(a)
        ms = (time.perf_counter() - t0) * 1e3
        assert ours == buf.getvalue(), stem
        print(f'    "{stem}": "{hashlib.sha256(ours).hexdigest()}",  '
              f'# {a.shape}, {len(ours)} B, encode {ms:.0f} ms',
              flush=True)
    print(os.cpu_count(), "host cores")
