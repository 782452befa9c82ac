"""ctypes bindings to the libavif 1.3.0 that PIL's wheel bundles
(pillow.libs/libavif-*.so), for the AVIF tests (a helper, not collected):
its YUV to RGB conversion, its plane scaler, its encoder (AV1 through
the wheel's libaom) and dav1d's CPU flags mask, with the struct offsets
of libavif 1.3.0 on x86-64.

avifImage: width 0, height 4, depth 8, yuvFormat 12, yuvRange 16, planes
24, row bytes 48, alphaPlane 64, alphaRowBytes 72, alphaPremultiplied 80,
colorPrimaries 104, transferCharacteristics 106, matrixCoefficients 108.
avifRGBImage: depth 8, format 12, pixels 48, rowBytes 56. avifEncoder:
maxThreads 4, speed 8, quality 32, qualityAlpha 36, min / max quantizer
40 / 44; codec-specific options through avifEncoderSetCodecSpecificOption.
"""

import ctypes
import glob
import os

import numpy as np
import PIL

LIBS = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
_lib = None
FORMATS = {"444": 1, "422": 2, "420": 3, "400": 4}


def lib():
    global _lib
    if _lib is None:
        L = ctypes.CDLL(glob.glob(os.path.join(LIBS, "libavif-*.so*"))[0])
        vp, u32 = ctypes.c_void_p, ctypes.c_uint32
        L.avifImageCreate.restype = vp
        L.avifImageCreate.argtypes = [u32] * 4
        L.avifImageAllocatePlanes.argtypes = [vp, ctypes.c_int]
        L.avifImageScale.argtypes = [vp, u32, u32, vp]
        L.avifImageDestroy.argtypes = [vp]
        L.avifRGBImageSetDefaults.argtypes = [vp, vp]
        L.avifRGBImageAllocatePixels.argtypes = [vp]
        L.avifRGBImageFreePixels.argtypes = [vp]
        L.avifImageYUVToRGB.argtypes = [vp, vp]
        L.avifImageRGBToYUV.argtypes = [vp, vp]
        L.avifEncoderCreate.restype = vp
        L.avifEncoderSetCodecSpecificOption.argtypes = [vp, ctypes.c_char_p,
                                                        ctypes.c_char_p]
        L.avifEncoderWrite.argtypes = [vp, vp, vp]
        L.avifEncoderDestroy.argtypes = [vp]
        L.avifRWDataFree.argtypes = [vp]
        L.dav1d_set_cpu_flags_mask.argtypes = [ctypes.c_uint]
        _lib = L
    return _lib


def dav1d_cpu_mask(mask: int) -> None:
    """dav1d_set_cpu_flags_mask of the dav1d 1.5.1 linked into the
    libavif: 0 keeps dav1d to its C functions, 0xffffffff (its default)
    lets it take the host's SIMD ones; it holds for the dav1d contexts
    opened after the call, so for PIL's decodes that follow."""
    lib().dav1d_set_cpu_flags_mask(mask)


def _at(addr, off, t):
    return t.from_address(addr + off)


def _put(ptr, rb, arr, depth=8):
    """Rows of an 8-bit plane (or pixels), or of a 10 / 12-bit plane as
    libavif's uint16 samples."""
    arr = np.ascontiguousarray(arr, np.uint8 if depth == 8 else np.uint16)
    for j in range(arr.shape[0]):
        ctypes.memmove(ptr + j * rb, arr[j].tobytes(), arr[j].nbytes)


def _get(ptr, rb, h, nbytes):
    buf = (ctypes.c_uint8 * (rb * h)).from_address(ptr)
    return np.frombuffer(bytes(buf), np.uint8).reshape(h, rb)[:, :nbytes]


def _image(w, h, fmt, full=True, mc=1, cp=1, tc=13, depth=8):
    L = lib()
    img = L.avifImageCreate(w, h, depth, FORMATS[fmt])
    _at(img, 16, ctypes.c_int).value = 1 if full else 0
    _at(img, 104, ctypes.c_uint16).value = cp
    _at(img, 106, ctypes.c_uint16).value = tc
    _at(img, 108, ctypes.c_uint16).value = mc
    return img


def convert(planes, fmt="444", full=True, mc=1, cp=1, alpha=None,
            premultiplied=False, depth=8):
    """avifImageYUVToRGB of 8, 10 or 12-bit planes (alpha of the same
    depth) into RGB8 (RGBA8 with an alpha plane): (result code, (H, W, 3
    or 4) u8 or None)."""
    L = lib()
    h, w = planes[0].shape
    img = _image(w, h, fmt, full, mc, cp, depth=depth)
    L.avifImageAllocatePlanes(img, 3 if alpha is not None else 1)
    for k, p in enumerate(planes):
        _put(_at(img, 24 + 8 * k, ctypes.c_void_p).value,
             _at(img, 48 + 4 * k, ctypes.c_uint32).value, p, depth)
    if alpha is not None:
        _put(_at(img, 64, ctypes.c_void_p).value,
             _at(img, 72, ctypes.c_uint32).value, alpha, depth)
        _at(img, 80, ctypes.c_int).value = int(premultiplied)
    rgb = ctypes.create_string_buffer(128)
    ra = ctypes.addressof(rgb)
    L.avifRGBImageSetDefaults(rgb, img)
    _at(ra, 8, ctypes.c_uint32).value = 8
    c = 4 if alpha is not None else 3
    _at(ra, 12, ctypes.c_int).value = 1 if alpha is not None else 0
    L.avifRGBImageAllocatePixels(rgb)
    r = L.avifImageYUVToRGB(img, rgb)
    out = None
    if r == 0:
        out = _get(_at(ra, 48, ctypes.c_void_p).value,
                   _at(ra, 56, ctypes.c_uint32).value, h, w * c
                   ).reshape(h, w, c).copy()
    L.avifRGBImageFreePixels(rgb)
    L.avifImageDestroy(img)
    return r, out


def scale(plane, dw, dh, depth=8):
    """avifImageScale of one 8, 10 or 12-bit plane (a 4:0:0 image)."""
    L = lib()
    h, w = plane.shape
    img = _image(w, h, "400", depth=depth)
    L.avifImageAllocatePlanes(img, 1)
    _put(_at(img, 24, ctypes.c_void_p).value,
         _at(img, 48, ctypes.c_uint32).value, plane, depth)
    diag = ctypes.create_string_buffer(512)
    r = L.avifImageScale(img, dw, dh, diag)
    assert r == 0, (r, diag.value)
    n = 1 if depth == 8 else 2
    out = _get(_at(img, 24, ctypes.c_void_p).value,
               _at(img, 48, ctypes.c_uint32).value, dh, dw * n).copy()
    if n == 2:
        out = out.view(np.uint16)
    L.avifImageDestroy(img)
    return out


def _rgb_image(rgb, fmt, full, mc, cp):
    """An avifImage holding avifImageRGBToYUV's planes of RGB8 / RGBA8."""
    L = lib()
    h, w, c = rgb.shape
    img = _image(w, h, fmt, full, mc, cp)
    rgbi = ctypes.create_string_buffer(128)
    ra = ctypes.addressof(rgbi)
    L.avifRGBImageSetDefaults(rgbi, img)
    _at(ra, 8, ctypes.c_uint32).value = 8
    _at(ra, 12, ctypes.c_int).value = 1 if c == 4 else 0
    pix = np.ascontiguousarray(rgb, np.uint8)
    _at(ra, 48, ctypes.c_void_p).value = pix.ctypes.data
    _at(ra, 56, ctypes.c_uint32).value = w * c
    r = L.avifImageRGBToYUV(img, rgbi)
    assert r == 0, r
    return img


def rgb_to_yuv(rgb: np.ndarray, fmt="420", mc=6, full=True, cp=1):
    """avifImageRGBToYUV's [Y, U, V] u8 planes of RGB8 / RGBA8 pixels, and
    its alpha plane (None for RGB)."""
    L = lib()
    h, w, c = rgb.shape
    img = _rgb_image(rgb, fmt, full, mc, cp)
    sx, sy = {"444": (0, 0), "422": (1, 0), "420": (1, 1)}[fmt]
    planes = []
    for k in range(3):
        ph, pw = (h, w) if k == 0 else ((h + sy) >> sy, (w + sx) >> sx)
        planes.append(_get(_at(img, 24 + 8 * k, ctypes.c_void_p).value,
                           _at(img, 48 + 4 * k, ctypes.c_uint32).value, ph,
                           pw).copy())
    alpha = None
    if c == 4:
        alpha = _get(_at(img, 64, ctypes.c_void_p).value,
                     _at(img, 72, ctypes.c_uint32).value, h, w).copy()
    L.avifImageDestroy(img)
    return planes, alpha


def encode(rgb: np.ndarray, fmt="420", mc=1, full=True, cp=1,
           quality=-1, lossless=False, speed=6, options=None,
           max_threads=1) -> bytes:
    """An AVIF file libavif writes from RGB8 or RGBA8 pixels: its own RGB
    to YUV in the given matrix, then avifEncoderWrite (libaom) with
    max_threads and libaom's codec-specific options (a dict, as PIL's
    advanced=). lossless sets quality and the quantizers to libavif's
    lossless values."""
    L = lib()
    img = _rgb_image(rgb, fmt, full, mc, cp)
    enc = L.avifEncoderCreate()
    _at(enc, 4, ctypes.c_int).value = max_threads
    for k, v in (options or {}).items():
        r = L.avifEncoderSetCodecSpecificOption(enc, k.encode(), v.encode())
        assert r == 0, (k, r)
    _at(enc, 8, ctypes.c_int).value = speed
    if lossless:
        quality = 100
        for off in (40, 44, 48, 52):
            _at(enc, off, ctypes.c_int).value = 0
    _at(enc, 32, ctypes.c_int).value = quality
    _at(enc, 36, ctypes.c_int).value = quality
    out = ctypes.create_string_buffer(16)
    r = L.avifEncoderWrite(enc, img, out)
    assert r == 0, r
    data = ctypes.string_at(_at(ctypes.addressof(out), 0, ctypes.c_void_p)
                            .value, _at(ctypes.addressof(out), 8,
                                        ctypes.c_size_t).value)
    L.avifRWDataFree(out)
    L.avifEncoderDestroy(enc)
    L.avifImageDestroy(img)
    return data
