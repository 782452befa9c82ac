"""The codecs PIL decodes here that the port read last (assets/zstd.py,
ccitt.py, lzw.py's old form, tiff.py's LZMA, 12-bit samples, planar YCbCr,
JPEG in planar and 12-bit files and old-style JPEG, jpeg.py's arithmetic
coding and lossless mode) against PIL, which the JAX package's load_image
uses:

  - every reader equals ``np.asarray(Image.open(p).convert("RGBA"))`` bit
    for bit, or raises where PIL raises, on files PIL writes here (CCITT
    MH / Group 3 1-D and 2-D / Group 4 in both fill orders and both
    photometric interpretations, LZMA, ZSTD with strips past 128 KiB so
    that a frame holds several blocks, 12-bit grey, planar YCbCr) and on
    files this test builds with encoders of its own where no encoder here
    writes them (JPEG SOF9 / SOF10 with the QM coder, SOF3 with every
    predictor and point transform, old-style LZW, old-style JPEG in both
    of its forms, 12-bit JPEG strips); PIL's decode is the check, never a
    round trip through the port;
  - cut and corrupted data: the same image or both raise;
  - assets/zstd.py against the libzstd that PIL links, on frames made
    at several levels, concatenated, skippable and checksummed;
  - the committed fixtures in tests/data/formats_codecs, each beside
    PIL's decode of it as PNG (chip_smoke.py decodes them on the card's
    machine, which has no PIL).

``PYTHONPATH=. python tests/test_torch_formats_codecs.py --write-fixtures``
regenerates tests/data/formats_codecs; without the flag it prints each
fixture's decode time on the host."""

import ctypes
import glob
import io
import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import PIL
import pytest
import torch
from PIL import Image

from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.assets import jpeg as tjpeg
from plainrenderer_tpu_torch.assets import zstd as tzstd
from test_torch_formats import _check, _picture, _pil, _save
from test_torch_formats_more import _tiff_file

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "data" / "formats_codecs"


# ------------------------------ helpers ------------------------------

def _same(data: bytes, suffix: str):
    """The port's outcome is PIL's: the same image, or both raise."""
    want = _pil(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            tio.decode_image(data, "case", suffix)
        return False
    np.testing.assert_array_equal(tio.decode_image(data, "case", suffix),
                                  want)
    return True


def _seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


# ------------------- JPEG: a test encoder of its own -------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])
_QUANT = (np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58,
                    60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29,
                    51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35,
                    55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120,
                    101, 72, 92, 95, 98, 112, 100, 103, 99]) + 1) // 2
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))


class _Comp:
    def __init__(self, cid, plane, h, v, hmax, vmax, w, hgt, unit):
        self.id, self.h, self.v = cid, h, v
        mcux = -(-w // (unit * hmax))
        mcuy = -(-hgt // (unit * vmax))
        self.bw, self.bh = mcux * h, mcuy * v
        self.w, self.hgt = -(-w * h // hmax), -(-hgt * v // vmax)
        self.nbx, self.nby = -(-self.w // unit), -(-self.hgt // unit)
        fx, fy = hmax // h, vmax // v
        p = np.pad(plane.astype(np.float64),
                   ((0, -hgt % fy), (0, -w % fx)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))
        self.plane = np.pad(np.round(p), ((0, self.bh * unit - p.shape[0]),
                                          (0, self.bw * unit - p.shape[1])),
                            mode="edge")


def _components(planes, factors, unit):
    hgt, w = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    comps = [_Comp(i + 1, p, h, v, hmax, vmax, w, hgt, unit)
             for i, (p, (h, v)) in enumerate(zip(planes, factors))]
    return comps, -(-w // (unit * hmax)), -(-hgt // (unit * vmax))


def _coefs(comp, q, precision=8):
    """Forward DCT and quantisation: (bh * bw, 64) natural order."""
    b = comp.plane.reshape(comp.bh, 8, comp.bw, 8).transpose(0, 2, 1, 3) \
        - (1 << (precision - 1))
    f = _DCT @ b @ _DCT.T
    return np.round(f / q.reshape(8, 8)).astype(np.int64).reshape(-1, 64)


def _order(comps, sel, mcux, mcuy):
    """(component index, block index) per MCU, as T.81 orders them."""
    if len(sel) == 1:
        c = comps[sel[0]]
        return [[(sel[0], by * c.bw + bx)] for by in range(c.nby)
                for bx in range(c.nbx)]
    out = []
    for my in range(mcuy):
        for mx in range(mcux):
            out.append([(i, (my * comps[i].v + v) * comps[i].bw
                         + mx * comps[i].h + h)
                        for i in sel for v in range(comps[i].v)
                        for h in range(comps[i].h)])
    return out


class _QM:
    """jcarith.c's QM encoder (T.81 D.1) with its byte stacking."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer, self.out = -1, bytearray()

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _flush_stack(self, byte):
        if self.zc:
            self.out += bytes(self.zc)
            self.zc = 0
        self._emit(byte)

    def encode(self, st, i, val):
        sv = st[i]
        qe = tjpeg.ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_stack(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_stack(self.buffer)
                    if self.sc:
                        self.out += bytes(self.zc)
                        self.zc = 0
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_stack(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_stack(self.buffer)
            if self.sc:
                self.out += bytes(self.zc)
                self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self.out += bytes(self.zc)
            self.zc = 0
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _qm_value(e, st, base, v, k, kx, dc, fixed):
    """Encode a nonzero v: its sign, magnitude category and bits (F.6-F.9,
    jcarith.c)."""
    sign = v < 0
    v = -v if sign else v
    if dc:
        e.encode(st, base + 1, sign)
        at = base + 2 + sign
    else:
        e.encode(fixed, 0, sign)
        at = base + 2
    m = 0
    v -= 1
    if v:
        e.encode(st, at, 1)
        m, v2 = 1, v
        if dc:
            at = 20
            v2 >>= 1
            while v2:
                e.encode(st, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
        else:
            v2 >>= 1
            if v2:
                e.encode(st, at, 1)
                m <<= 1
                at = 189 if k <= kx else 217
                v2 >>= 1
                while v2:
                    e.encode(st, at, 1)
                    m <<= 1
                    at += 1
                    v2 >>= 1
    e.encode(st, at, 0)
    at += 14
    m >>= 1
    while m:
        e.encode(st, at, 1 if m & v else 0)
        m >>= 1


def _qm_dc(e, st, ctx, diff, lo, hi):
    """Figure F.4 with F.1.4.4.1.2's conditioning; returns the context."""
    if diff == 0:
        e.encode(st, ctx, 0)
        return 0
    e.encode(st, ctx, 1)
    sign = diff < 0
    _qm_value(e, st, ctx, diff, 0, 0, True, None)
    m = abs(diff) - 1
    mag = 1 << (m.bit_length() - 1) if m else 0
    if mag < (1 << lo) >> 1:
        return 0
    return (12 if mag > (1 << hi) >> 1 else 4) + 4 * sign


def _qm_ac(e, st, fixed, block, ss, se, kx):
    """Figure F.5 / G.1.3.2 over the (point-transformed) values."""
    ke = se
    while ke >= ss and block[ZIGZAG[ke]] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        at = 3 * (k - 1)
        e.encode(st, at, 0)
        while block[ZIGZAG[k]] == 0:
            e.encode(st, at + 1, 0)
            at += 3
            k += 1
        e.encode(st, at + 1, 1)
        _qm_value(e, st, at, int(block[ZIGZAG[k]]), k, kx, False, fixed)
        k += 1
    if k <= se:
        e.encode(st, 3 * (k - 1), 1)


def _qm_ac_refine(e, st, fixed, block, ss, se, ah, al):
    """jcarith.c encode_mcu_AC_refine."""
    absv = np.abs(block[ZIGZAG])
    ke = se
    while ke > 0 and not absv[ke] >> al:
        ke -= 1
    kex = ke
    while kex > 0 and not absv[kex] >> ah:
        kex -= 1
    k = ss
    while k <= ke:
        at = 3 * (k - 1)
        if k > kex:
            e.encode(st, at, 0)
        while True:
            v = int(absv[k]) >> al
            if v:
                if v >> 1:
                    e.encode(st, at + 2, v & 1)
                else:
                    e.encode(st, at + 1, 1)
                    e.encode(fixed, 0, int(block[ZIGZAG[k]] < 0))
                break
            e.encode(st, at + 1, 0)
            at += 3
            k += 1
        k += 1
    if k <= se:
        e.encode(st, 3 * (k - 1), 1)


def _shift(v, al):
    """The point transform of jcarith.c: magnitudes shifted, sign kept."""
    return np.where(v < 0, -((-v) >> al), v >> al)


def _frame_head(sof, comps, w, h, quant=True, precision=8, jfif=True):
    out = b"\xff\xd8"
    if jfif:
        out += _seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if quant:
        out += _seg(0xDB, bytes([0]) + bytes(_QUANT[ZIGZAG].astype(np.uint8)))
    body = bytes([precision]) + struct.pack(">HHB", h, w, len(comps))
    for c in comps:
        body += bytes([c.id, c.h << 4 | c.v, 0])
    return out + _seg(sof, body)


def _arith_jpeg(planes, factors=None, scans=None, restart=0, dac=b"",
                progressive=False, precision=8):
    """An arithmetic-coded JPEG (SOF9, or SOF10 with `progressive`) of the
    (H, W) u8 planes: every component on table 0, `scans` a list of
    (component indices, Ss, Se, Ah, Al)."""
    factors = factors or [(1, 1)] * len(planes)
    h, w = planes[0].shape
    comps, mcux, mcuy = _components(planes, factors, 8)
    coefs = [_coefs(c, _QUANT, precision) for c in comps]
    if scans is None:
        scans = [(list(range(len(comps))), 0, 63, 0, 0)]
    lo, hi, kx = 0, 1, 5
    for i in range(0, len(dac), 2):
        if dac[i] == 0:
            lo, hi = dac[i + 1] & 15, dac[i + 1] >> 4
        elif dac[i] == 16:
            kx = dac[i + 1]
    out = _frame_head(0xCA if progressive else 0xC9, comps, w, h,
                      precision=precision)
    if dac:
        out += _seg(0xCC, dac)
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    for sel, ss, se, ah, al in scans:
        body = bytes([len(sel)])
        for i in sel:
            body += bytes([comps[i].id, 0x00])
        out += _seg(0xDA, body + bytes([ss, se, ah << 4 | al]))
        mcus = _order(comps, sel, mcux, mcuy)
        per = restart or len(mcus)
        for k in range(0, len(mcus), per):
            e = _QM()
            dc_st, ac_st, fixed = [0] * 64, [0] * 256, [113]
            last, ctx = [0] * len(comps), [0] * len(comps)
            for mcu in mcus[k:k + per]:
                for ci, blk in mcu:
                    b = coefs[ci][blk]
                    if not progressive:
                        ctx[ci] = _qm_dc(e, dc_st, ctx[ci],
                                         int(b[0]) - last[ci], lo, hi)
                        last[ci] = int(b[0])
                        _qm_ac(e, ac_st, fixed, b, 1, 63, kx)
                    elif ss == 0 and ah == 0:
                        v = int(b[0]) >> al
                        ctx[ci] = _qm_dc(e, dc_st, ctx[ci], v - last[ci],
                                         lo, hi)
                        last[ci] = v
                    elif ss == 0:
                        e.encode(fixed, 0, (int(b[0]) >> al) & 1)
                    elif ah == 0:
                        _qm_ac(e, ac_st, fixed, _shift(b, al), ss, se, kx)
                    else:
                        _qm_ac_refine(e, ac_st, fixed, b, ss, se, ah, al)
            out += e.finish()
            if k + per < len(mcus):
                out += bytes([0xFF, 0xD0 + (k // per) % 8])
    return out + b"\xff\xd9"


def _rgb_planes(w, h, seed):
    """JFIF YCbCr planes of a picture."""
    a = _picture(w, h, 3, seed).astype(np.float64)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return [np.clip(np.round(p), 0, 255).astype(np.uint8) for p in (y, cb,
                                                                     cr)]


PROGRESSION = [  # libjpeg's default script for YCbCr, refinement included
    ([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
    ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
    ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
    ([0], 1, 63, 1, 0)]


@pytest.mark.parametrize("size", [(1, 1), (8, 8), (13, 21), (40, 24)])
@pytest.mark.parametrize("kind", ["grey", "444", "420", "422"])
def test_jpeg_arithmetic_sequential(size, kind):
    w, h = size
    if kind == "grey":
        planes, factors = [_picture(w, h, 1, w)[..., 0]], None
    else:
        planes = _rgb_planes(w, h, w + h)
        factors = {"444": None, "420": [(2, 2), (1, 1), (1, 1)],
                   "422": [(2, 1), (1, 1), (1, 1)]}[kind]
    _check(_arith_jpeg(planes, factors), ".jpg")


GREY_PROGRESSION = [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2),
                    ([0], 1, 63, 2, 1), ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]


@pytest.mark.parametrize("size", [(1, 1), (13, 21), (40, 24)])
@pytest.mark.parametrize("kind", ["grey", "420"])
def test_jpeg_arithmetic_progressive(size, kind):
    """SOF10: spectral selection and successive approximation, DC and AC
    refinement scans; a file cut after its first scans is block-smoothed
    as libjpeg-turbo smooths it."""
    w, h = size
    if kind == "grey":
        planes, factors, script = ([_picture(w, h, 1, h)[..., 0]], None,
                                   GREY_PROGRESSION)
    else:
        planes, factors, script = (_rgb_planes(w, h, w), [(2, 2), (1, 1),
                                                          (1, 1)],
                                   PROGRESSION)
    for scans in (script, script[:3]):
        _check(_arith_jpeg(planes, factors, scans, progressive=True), ".jpg")


def test_jpeg_arithmetic_restarts_and_conditioning():
    """Restart intervals reset the statistics and the DC predictions; DAC
    conditioning (L, U, Kx) other than the defaults."""
    w, h = 37, 29
    planes = _rgb_planes(w, h, 7)
    f420 = [(2, 2), (1, 1), (1, 1)]
    for restart in (1, 3):
        _check(_arith_jpeg(planes, f420, restart=restart), ".jpg")
        _check(_arith_jpeg(planes, f420, PROGRESSION, restart=restart,
                           progressive=True), ".jpg")
    for dac in (bytes([0, 5 << 4 | 2, 16, 2]), bytes([0, 0x11, 16, 63]),
                bytes([0, 15 << 4 | 0, 16, 1])):
        _check(_arith_jpeg(planes, f420, dac=dac), ".jpg")
        _check(_arith_jpeg(planes, f420, PROGRESSION, dac=dac,
                           progressive=True), ".jpg")


@pytest.mark.parametrize("marker", [0xCB, 0xC5, 0xC6, 0xC7, 0xCD, 0xCE,
                                    0xCF])
def test_jpeg_modes_refused_by_both(marker):
    """Lossless arithmetic coding (SOF11), which libjpeg-turbo does not
    implement, and the hierarchical modes (SOF5-7, SOF13-15), which it
    refuses: PIL refuses a file so marked, and the port names the mode."""
    w, h = 13, 9
    grey = _picture(w, h, 1, marker)[..., 0]
    base = (_lossless_jpeg([grey], 1) if marker in (0xCB, 0xC7, 0xCF)
            else _arith_jpeg([grey]))
    sof = base.index(b"\xff\xc3" if marker in (0xCB, 0xC7, 0xCF)
                     else b"\xff\xc9")
    data = base[:sof + 1] + bytes([marker]) + base[sof + 2:]
    assert isinstance(_pil(data), Exception)
    with pytest.raises(ValueError, match="lossless|hierarchical"):
        tio.decode_image(data, "case", ".jpg")


def _huffman_bits(symbols):
    """Standard DC luminance codes for (category, extra bits, length)
    triples, byte-stuffed."""
    counts, syms = _DC_LUMA
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[syms[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    acc, n, out = 0, 0, bytearray()
    for s, extra in symbols:
        c, ln = codes[s]
        acc, n = (acc << ln) | c, n + ln
        if s and s != 16:
            acc, n = (acc << s) | (extra & ((1 << s) - 1)), n + s
        while n >= 8:
            b = (acc >> (n - 8)) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0)
            n -= 8
    if n:
        b = ((acc << (8 - n)) | ((1 << (8 - n)) - 1)) & 0xFF
        out.append(b)
        if b == 0xFF:
            out.append(0)
    return bytes(out)


def _predict(rows, r, x, predictor, first, initial):
    """T.81 H.1.2.1 on already reconstructed samples."""
    if first:
        return initial if x == 0 else rows[r][x - 1]
    if x == 0:
        return rows[r - 1][0]
    ra, rb, rc = rows[r][x - 1], rows[r - 1][x], rows[r - 1][x - 1]
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]


def _lossless_jpeg(planes, predictor, pt=0, restart=0, factors=None,
                   rgb=False):
    """A lossless Huffman JPEG (SOF3) of the (H, W) u8 planes in one
    interleaved scan (one scan per component with `factors` subsampled);
    JFIF, or with `rgb` the component ids R, G, B and no JFIF marker."""
    factors = factors or [(1, 1)] * len(planes)
    h, w = planes[0].shape
    comps, mcux, mcuy = _components(planes, factors, 1)
    if rgb:
        for c, cid in zip(comps, b"RGB"):
            c.id = cid
    table = bytes([0]) + bytes(_DC_LUMA[0]) + bytes(_DC_LUMA[1])
    out = _frame_head(0xC3, comps, w, h, quant=False, jfif=not rgb)
    out += _seg(0xC4, table)
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    sels = ([list(range(len(comps)))] if len(set(factors)) == 1
            else [[i] for i in range(len(comps))])
    initial = 1 << (8 - pt - 1)
    for sel in sels:
        body = bytes([len(sel)])
        for i in sel:
            body += bytes([comps[i].id, 0x00])
        out += _seg(0xDA, body + bytes([predictor, 0, pt]))
        per_row = mcux if len(sel) > 1 else comps[sel[0]].nbx
        rows_per = max(restart // per_row, 1) if restart else 1 << 30
        diffs = {}
        for i in sel:
            c = comps[i]
            x = (c.plane.astype(np.int64) >> pt).tolist()
            vrows = c.v if len(sel) > 1 else 1
            d = np.zeros((c.bh, c.bw), np.int64)
            for r in range(c.nby):
                first = (r // vrows) % rows_per == 0 and r % vrows == 0
                for xx in range(c.nbx):
                    p = _predict(x, r, xx, predictor, first, initial)
                    d[r, xx] = ((x[r][xx] - p + 32768) & 0xFFFF) - 32768
            diffs[i] = d.reshape(-1)
        mcus = _order(comps, sel, mcux, mcuy)
        per = restart or len(mcus)
        for k in range(0, len(mcus), per):
            syms = []
            for mcu in mcus[k:k + per]:
                for i, blk in mcu:
                    v = int(diffs[i][blk])
                    s = abs(v).bit_length()
                    syms.append((s, v if v >= 0 else v - 1))
            out += _huffman_bits(syms)
            if k + per < len(mcus):
                out += bytes([0xFF, 0xD0 + (k // per) % 8])
    return out + b"\xff\xd9"


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("size", [(1, 1), (7, 5), (33, 17)])
def test_jpeg_lossless_predictors(predictor, size):
    """SOF3 with each predictor and point transforms 0 and 3, grey and RGB;
    JFIF YCbCr, which libjpeg-turbo will not convert in lossless mode, is
    refused by both."""
    w, h = size
    grey = _picture(w, h, 1, predictor)[..., 0]
    for pt in (0, 3):
        _check(_lossless_jpeg([grey], predictor, pt), ".jpg")
    rgb = list(np.moveaxis(_picture(w, h, 3, predictor), -1, 0))
    _check(_lossless_jpeg(rgb, predictor, 1, rgb=True), ".jpg")
    data = _lossless_jpeg(rgb, predictor)
    assert isinstance(_pil(data), Exception)
    with pytest.raises(ValueError, match="lossless"):
        tio.decode_image(data, "case", ".jpg")


def test_jpeg_lossless_restarts_and_sampling():
    """Restart intervals of whole MCU rows (and one that is not, which
    libjpeg-turbo refuses); subsampled components, one scan each,
    replicated; RGB without JFIF (component ids R, G, B)."""
    w, h = 23, 14
    planes = list(np.moveaxis(_picture(w, h, 3, 3), -1, 0))
    for restart in (w, 2 * w):
        _check(_lossless_jpeg(planes, 4, restart=restart, rgb=True), ".jpg")
        _check(_lossless_jpeg(planes[:1], 6, 2, restart=restart), ".jpg")
    data = _lossless_jpeg(planes, 4, restart=w + 1, rgb=True)
    assert isinstance(_pil(data), Exception)
    with pytest.raises(ValueError, match="restart"):
        tio.decode_image(data, "case", ".jpg")
    _same(_lossless_jpeg(planes, 7, factors=[(2, 2), (1, 1), (1, 1)],
                         rgb=True), ".jpg")
    _same(_lossless_jpeg(planes, 5, 1, factors=[(2, 1), (1, 1), (1, 1)],
                         restart=12, rgb=True), ".jpg")


def _flips(data: bytes, n: int, seed: int, lo: int = 2, hi=None):
    """n copies of data, each with one random bit flipped in [lo, hi)."""
    rng = np.random.default_rng(seed)
    hi = len(data) - 2 if hi is None else hi
    out = []
    for _ in range(n):
        bad = bytearray(data)
        bad[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(bad))
    return out


def test_jpeg_arithmetic_and_lossless_cut_and_corrupt():
    """Corrupt data as libjpeg-turbo reads it: the QM decoder's zeros past a
    marker and its overflow state, the restart resynchronisation, a bad
    Huffman code read as 0 after 17 bits, a lossless row after the data
    ran out reset to 2^(P - Pt - 1), the AVX2 IDCT's 16-bit wrap and
    saturation on huge coefficients, the header checks (lengths, table
    indexes, sampling factors); a file cut before its EOI is refused by
    both (PIL: image file is truncated). The same image or both raise."""
    w, h = 37, 29
    planes = _rgb_planes(w, h, 7)
    rgb = list(np.moveaxis(_picture(w, h, 3, 3), -1, 0))
    f420 = [(2, 2), (1, 1), (1, 1)]
    files = [_arith_jpeg(planes, f420, restart=2),
             _arith_jpeg(planes, f420, PROGRESSION, restart=3,
                         progressive=True),
             _lossless_jpeg(rgb, 6, 1, restart=2 * w, rgb=True),
             _lossless_jpeg([planes[0]], 5, 2, restart=w)]
    outcomes = []
    for k, data in enumerate(files):
        for cut in (1, 2, len(data) // 2):
            assert not _same(data[:-cut], ".jpg")
        outcomes += [_same(c, ".jpg") for c in _flips(data, 25, k)]
    assert any(outcomes) and not all(outcomes)


def test_jpeg_huffman_cut_and_corrupt():
    """The same reading of cut and corrupt data on the Huffman files PIL
    writes (baseline, progressive with restart intervals, grey with a
    restart every MCU): a file cut before EOI is refused by both, a flip
    gives the same image or both raise."""
    w, h = 37, 29
    img = Image.fromarray(_picture(w, h, 3, 1))
    files = [_save(img, "JPEG"),
             _save(img, "JPEG", progressive=True, restart_marker_blocks=2),
             _save(img.convert("L"), "JPEG", restart_marker_blocks=1)]
    outcomes = []
    for k, data in enumerate(files):
        for cut in (1, 2, len(data) // 2):
            assert not _same(data[:-cut], ".jpg")
        outcomes += [_same(c, ".jpg") for c in _flips(data, 20, 10 + k)]
    assert any(outcomes) and not all(outcomes)


# ------------------------------- ZSTD --------------------------------

def _libzstd():
    """The libzstd that PIL's libtiff links (an independent encoder and
    decoder for the frame tests)."""
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(glob.glob(str(libs / "libzstd*.so*")))
    assert found, "PIL is linked with libzstd here"
    lib = ctypes.CDLL(found[0])
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    return lib


def _zstd_compress(lib, data: bytes, level: int, checksum=False,
                   window_log=0) -> bytes:
    cctx = lib.ZSTD_createCCtx()
    try:
        lib.ZSTD_CCtx_setParameter(cctx, 100, level)
        lib.ZSTD_CCtx_setParameter(cctx, 201, int(checksum))
        if window_log:
            lib.ZSTD_CCtx_setParameter(cctx, 101, window_log)
        cap = len(data) + len(data) // 128 + 1024
        dst = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, dst, cap, data, len(data))
        assert not lib.ZSTD_isError(n)
        return dst.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def _zstd_reference(lib, frame: bytes, size: int):
    dst = ctypes.create_string_buffer(size + 64)
    n = lib.ZSTD_decompress(dst, size + 64, frame, len(frame))
    return None if lib.ZSTD_isError(n) else dst.raw[:n]


@pytest.mark.parametrize("level", [1, 3, 9, 19, -5])
def test_zstd_frames_equal_libzstd(level):
    """Frames libzstd writes at several levels, multi-block (past 128
    KiB: repeat tables, treeless literals, repeat offsets across blocks),
    with and without the content checksum."""
    lib = _libzstd()
    for n, seed in ((1, 0), (700, 1), (140_000, 2)):
        data = _picture(256, n // 768 + 1, 3, seed).reshape(-1)[:n].tobytes()
        for checksum in (False, True):
            frame = _zstd_compress(lib, data, level, checksum)
            assert tzstd.decompress(frame) == data
    rng = np.random.default_rng(level & 7)
    text = bytes(rng.choice(np.frombuffer(b"abcde fghij\n", np.uint8),
                            140_000).astype(np.uint8))
    # and runs, noise, short texts: RLE blocks, raw and RLE literals, a
    # single Huffman stream
    for data in (text, bytes(5000), rng.bytes(3000), b"zstd " * 40 + text[:90],
                 bytes(300) + rng.bytes(40) + bytes(300)):
        assert tzstd.decompress(_zstd_compress(lib, data, level)) == data


def test_zstd_concatenated_skippable_and_corrupt_frames():
    lib = _libzstd()
    a = _picture(64, 40, 3, 1).tobytes()
    b = bytes(range(256)) * 40
    fa, fb = _zstd_compress(lib, a, 3, True), _zstd_compress(lib, b, 9)
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    assert tzstd.decompress(fa + skip + fb + skip) == a + b
    with pytest.raises(ValueError, match="ZSTD"):
        tzstd.decompress(fa[:-1] + bytes([fa[-1] ^ 1]))  # the checksum
    rng = np.random.default_rng(5)
    agree = 0
    for _ in range(40):
        bad = bytearray(fb)
        at = int(rng.integers(6, len(bad)))
        bad[at] ^= 1 << int(rng.integers(0, 8))
        want = _zstd_reference(lib, bytes(bad), len(b))
        try:
            got = tzstd.decompress(bytes(bad))
        except ValueError:
            got = None
        assert got == want, at
        agree += want is not None
    assert tzstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert tzstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    # a dictionary ID (4 bytes, flag 3) in the frame header: refused by name
    at = 5 if fb[4] & 0x20 else 6  # after the window descriptor, if any
    with_dict = fb[:4] + bytes([fb[4] | 3]) + fb[5:at] + b"\x07\0\0\0" + \
        fb[at:]
    with pytest.raises(ValueError, match="dictionary"):
        tzstd.decompress(with_dict)


# ------------------------------- CCITT -------------------------------

def _bilevel(w, h, seed):
    """Text-like bilevel pictures: strokes, blocks, long runs, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = ((x // 3 + y // 5) % 7 == 0) | ((x - 2 * y) % 23 < 3)
    a[h // 3:h // 2, w // 4:w // 2] = True
    a ^= rng.random((h, w)) < 0.03
    return Image.fromarray(~a).convert("1")


def _patch_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with one SHORT tag's inline value changed."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    for k in range(n):
        e = ifd + 2 + 12 * k
        if struct.unpack_from("<H", data, e)[0] == tag:
            return data[:e + 8] + struct.pack("<H", value) + data[e + 10:]
    raise KeyError(tag)


CCITT = [("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 4}),
         ("group3", {292: 1}), ("group3", {292: 5}), ("group4", {})]


@pytest.mark.parametrize("comp,info", CCITT,
                         ids=[f"{c}-{i}" for c, i in CCITT])
@pytest.mark.parametrize("size", [(1, 1), (37, 21), (64, 64), (300, 9)])
def test_ccitt_written_by_pil(comp, info, size):
    """MH, T.4 1-D and 2-D with and without EOL fill, T.6; both fill
    orders, both photometric interpretations, strips of several rows."""
    img = _bilevel(*size, size[0])
    for extra in ({}, {266: 2}, {278: 5}):
        data = _save(img, "TIFF", compression=comp, tiffinfo={**info, **extra})
        _check(data, ".tif")
        _check(_patch_tag(data, 262, 0), ".tif")


def _libtiff():
    """The libtiff PIL links, through ctypes (PIL.Image loaded its
    dependencies)."""
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(glob.glob(str(libs / "libtiff*.so*")))
    assert found, "PIL is linked with libtiff here"
    lib = ctypes.CDLL(found[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.c_void_p, ctypes.c_ssize_t]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    lib.TIFFStripSize.argtypes = [ctypes.c_void_p]
    lib.TIFFStripSize.restype = ctypes.c_ssize_t
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFSetWarningHandler.argtypes = [ctypes.c_void_p]
    lib.TIFFSetErrorHandler.argtypes = [ctypes.c_void_p]
    lib.TIFFSetWarningHandler(None)
    lib.TIFFSetErrorHandler(None)
    return lib


def _libtiff_strip(lib, path: Path, fill: int):
    """libtiff's TIFFReadEncodedStrip of strip 0 into a buffer of `fill`
    bytes: (its return value, the buffer). PIL calls the same function on
    a buffer it does not clear."""
    tif = lib.TIFFOpen(str(path).encode(), b"r")
    assert tif
    try:
        n = lib.TIFFStripSize(tif)
        buf = ctypes.create_string_buffer(bytes([fill]) * n, n)
        return lib.TIFFReadEncodedStrip(tif, 0, buf, -1), buf.raw
    finally:
        lib.TIFFClose(tif)


@pytest.mark.parametrize("comp", ["tiff_ccitt", "group3", "group4"])
def test_ccitt_cut_and_corrupt_strips(comp, tmp_path):
    """libtiff's handling of bad codes (the row padded or cut to its
    width, the EOL resynchronising the next row), of data that ends early
    (an error; Group 4 ends the strip after its first row; Group 3 decodes
    the strip again without EOLs) and of rows with more changes than its
    run buffer: the port equals libtiff's decode into a cleared buffer,
    and PIL's decode wherever libtiff writes every row (PIL's buffer is
    not cleared, so rows libtiff leaves are not PIL's to compare)."""
    lib = _libtiff()
    w, h = 45, 30
    img = _bilevel(w, h, 7)
    code = {"tiff_ccitt": 2, "group3": 3, "group4": 4}[comp]
    rng = np.random.default_rng(code)
    for info in ({}, {292: 1}) if comp == "group3" else ({},):
        data = _save(img, "TIFF", compression=comp, tiffinfo=info)
        (ifd,) = struct.unpack_from("<I", data, 4)  # the strip is 8:ifd
        strip = data[8:ifd]
        tags = {258: (3, [1]), 259: (3, [code]), 262: (3, [1]),
                277: (3, [1]), 278: (4, [h]), **{
                    k: (4, [v]) for k, v in info.items()}}
        cases = [data[:8 + cut] + bytes(ifd - 8 - cut) + data[ifd:]
                 for cut in (1, 5, 17, 40)]
        cases += [_tiff_file(w, h, [strip[:cut]], tags)
                  for cut in (1, 3, 9, 30, 100, len(strip) - 1)]
        for _ in range(25):
            bad = bytearray(data)
            bad[int(rng.integers(8, ifd))] ^= 1 << int(rng.integers(0, 8))
            cases.append(bytes(bad))
        for k, case in enumerate(cases):
            path = tmp_path / f"{k}.tif"
            path.write_bytes(case)
            ret, cleared = _libtiff_strip(lib, path, 0)
            if ret < 0:
                assert isinstance(_pil(case), Exception)
                with pytest.raises(ValueError, match="CCITT"):
                    tio.decode_image(case, "case", ".tif")
                continue
            bits = np.unpackbits(np.frombuffer(cleared, np.uint8).reshape(
                h, -1), axis=1)[:, :w]
            got = tio.decode_image(case, "case", ".tif")
            np.testing.assert_array_equal(got[..., 0], bits * 255)
            if _libtiff_strip(lib, path, 0xFF)[1] == cleared:
                _same(case, ".tif")


# ------------------------- TIFF LZMA and ZSTD -------------------------

MODES = ("L", "RGB", "RGBA", "I;16", "1", "P")


def _mode_image(mode, w, h, seed):
    a = _picture(w, h, 4, seed)
    if mode == "I;16":
        return Image.frombytes("I;16", (w, h), (a[..., 0].astype("<u2") * 37)
                               .tobytes())
    if mode == "P":
        return Image.fromarray(a[..., :3]).quantize(17)
    if mode == "1":
        return _bilevel(w, h, seed)
    if mode == "L":
        return Image.fromarray(a[..., 0].copy())
    return Image.fromarray(a[..., :len(mode)].copy(), mode)


@pytest.mark.parametrize("comp", ["lzma", "zstd"])
@pytest.mark.parametrize("size", [(1, 1), (7, 5), (33, 17)])
def test_tiff_lzma_and_zstd_written_by_pil(comp, size):
    """Every mode PIL writes, with and without the horizontal predictor,
    in one strip and in strips of 2 rows."""
    for mode in MODES:
        img = _mode_image(mode, *size, size[0])
        for info in ({}, {317: 2}, {278: 2}):
            if 317 in info and mode in ("1", "P"):
                continue
            _check(_save(img, "TIFF", compression=comp, tiffinfo=info), ".tif")


def test_tiff_zstd_strips_of_several_blocks():
    """Strips past 128 KiB (strip_size raised): a frame of several blocks,
    the later ones with repeat tables, treeless literals and repeat
    offsets, as libzstd writes them for PIL's libtiff."""
    for size, mode, kw in (((300, 200), "RGB", {}),
                           ((256, 300), "RGBA", {"tiffinfo": {317: 2}}),
                           ((600, 240), "L", {})):
        img = _mode_image(mode, *size, size[1])
        data = _save(img, "TIFF", compression="zstd", strip_size=1 << 21, **kw)
        with Image.open(io.BytesIO(data)) as im:
            assert im.tag_v2[278] == size[1]  # one strip
        _check(data, ".tif")


@pytest.mark.parametrize("comp", ["lzma", "zstd"])
def test_tiff_lzma_and_zstd_cut_and_corrupt(comp):
    """Cut and corrupted strips: the same image or both raise."""
    img = _mode_image("RGB", 40, 30, 3)
    data = _save(img, "TIFF", compression=comp)
    (ifd,) = struct.unpack_from("<I", data, 4)
    rng = np.random.default_rng(7)
    cases = [data[:8 + cut] + bytes(ifd - 8 - cut) + data[ifd:]
             for cut in (0, 3, 12, (ifd - 8) // 2, ifd - 9)]
    for _ in range(30):
        bad = bytearray(data)
        bad[int(rng.integers(8, ifd))] ^= 1 << int(rng.integers(0, 8))
        cases.append(bytes(bad))
    outcomes = [_same(c, ".tif") for c in cases]
    assert not all(outcomes) and any(outcomes)


# --------------------------- 12-bit samples ---------------------------

def _pack12(v):
    """(rows, n) samples -> rows of 12-bit big-endian-packed bytes."""
    rows, n = v.shape
    bits = ((v[..., None] >> np.arange(11, -1, -1)) & 1).reshape(rows, -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _tiff12(v, compression=1, bo="<", photometric=1, extra_tags=None,
            rows_per_strip=None):
    h, w = v.shape[:2]
    spp = v.shape[2] if v.ndim == 3 else 1
    rps = rows_per_strip or h
    chunks = []
    for y in range(0, h, rps):
        raw = _pack12(v[y:y + rps].reshape(min(rps, h - y), -1)).tobytes()
        chunks.append(zlib.compress(raw) if compression == 8 else raw)
    tags = {258: (3, [12] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 278: (4, [rps]),
            **(extra_tags or {})}
    return _tiff_file(w, h, chunks, tags, bo=bo)


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (33, 17), (8, 3)])
def test_tiff_12bit_grey(size):
    """Little-endian BlackIsZero 12-bit grey, PIL's I;12 (then I;16,
    clipped at 255 by convert), uncompressed and Deflate, in strips;
    other 12-bit layouts refused as PIL refuses them."""
    w, h = size
    rng = np.random.default_rng(w)
    v = rng.integers(0, 4096, (h, w))
    v[rng.random((h, w)) < 0.5] %= 300  # many values below 255
    for comp in (1, 8):
        _check(_tiff12(v, comp), ".tif")
        _check(_tiff12(v, comp, rows_per_strip=2), ".tif")
    for case in (_tiff12(v, 1, ">"), _tiff12(v, 1, photometric=0),
                 _tiff12(np.stack([v] * 3, -1), 1, photometric=2),
                 _tiff12(v, 8, extra_tags={317: (3, [2])}),
                 _tiff12(v, 1, extra_tags={266: (3, [2])})):
        assert isinstance(_pil(case), Exception)
        with pytest.raises(ValueError):
            tio.decode_image(case, "case", ".tif")


# ---------------------------- planar YCbCr ----------------------------

def _planar_ycbcr(ycc, compression, sub=None, extra=None, tile=None):
    h, w, _ = ycc.shape
    if tile:
        tw, th = tile
        chunks = []
        for k in range(3):
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw), np.uint8)
                    part = ycc[ty:ty + th, tx:tx + tw, k]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(t.tobytes())
    else:
        chunks = [ycc[..., k].tobytes() for k in range(3)]
    if compression == 8:
        chunks = [zlib.compress(c) for c in chunks]
    tags = {258: (3, [8, 8, 8]), 259: (3, [compression]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [2]), **(extra or {})}
    if not tile:
        tags[278] = (4, [h])
    if sub:
        tags[530] = (3, list(sub))
    return _tiff_file(w, h, chunks, tags, tiled=tile)


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (33, 17)])
def test_tiff_planar_ycbcr(size):
    """Uncompressed planes read raw as R, G, B (PIL's raw decoder, any
    subsampling tag); compressed planes converted by libtiff's RGBA
    interface at 1 x 1 (with the file's coefficients and reference
    black and white), refused at other subsamplings."""
    w, h = size
    ycc = _picture(w, h, 3, w + 1)
    for sub in (None, (1, 1), (2, 2), (2, 1)):
        _check(_planar_ycbcr(ycc, 1, sub), ".tif")
    _check(_planar_ycbcr(ycc, 8, (1, 1)), ".tif")
    _check(_planar_ycbcr(ycc, 8, (1, 1), tile=(16, 16)), ".tif")
    _check(_planar_ycbcr(ycc, 8, (1, 1), {
        529: (5, [(2990, 10000), (5870, 10000), (1140, 10000)]),
        532: (5, [(15, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                  (240, 1)])}), ".tif")
    for sub in (None, (2, 2), (2, 1), (4, 4)):
        case = _planar_ycbcr(ycc, 8, sub)
        assert isinstance(_pil(case), Exception)
        with pytest.raises(ValueError, match="planar YCbCr"):
            tio.decode_image(case, "case", ".tif")


# ----------------------- JPEG in planar TIFF files ---------------------

def _jpeg_segments(data: bytes):
    """(marker, bytes) of a JPEG's segments, the scan's entropy-coded data
    and EOI with the SOS segment."""
    out, i = [], 2
    while data[i + 1] != 0xDA:
        n = data[i + 2] << 8 | data[i + 3]
        out.append((data[i + 1], data[i:i + 2 + n]))
        i += 2 + n
    out.append((0xDA, data[i:]))
    return out


def _jpeg_planes(px, photometric, sub=None, quality=90, tables=False):
    """A planar TIFF whose strips are one grey JPEG per plane (with
    `tables` abbreviated, after a JPEGTables stream)."""
    h, w, spp = px.shape
    chunks = [_save(Image.fromarray(px[..., k].copy()), "JPEG",
                    quality=quality) for k in range(spp)]
    tags = {258: (3, [8] * spp), 259: (3, [7]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [2]), 278: (4, [h])}
    if sub:
        tags[530] = (3, list(sub))
    if tables:  # DQT and DHT in JPEGTables, SOF and the scan per strip
        segs = _jpeg_segments(chunks[0])
        tags[347] = b"\xff\xd8" + b"".join(
            v for m, v in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
        chunks = [b"\xff\xd8" + b"".join(v for m, v in _jpeg_segments(c)
                                         if m in (0xC0, 0xDA))
                  for c in chunks]
    return _tiff_file(w, h, chunks, tags)


@pytest.mark.parametrize("size", [(1, 1), (9, 7), (33, 17)])
def test_tiff_jpeg_in_planar_files(size):
    """Planar RGB and RGBA (each plane a 1-component JPEG, left as
    stored), planar YCbCr at 1 x 1 (libtiff's conversion), abbreviated
    streams after JPEGTables; a 3-component JPEG in a plane, and planar
    YCbCr JPEG at 2 x 2, refused by both."""
    w, h = size
    px = _picture(w, h, 4, h)
    _check(_jpeg_planes(px[..., :3].copy(), 2), ".tif")
    _check(_jpeg_planes(px[..., :3].copy(), 2, tables=True), ".tif")
    _check(_jpeg_planes(px[..., :3].copy(), 6, (1, 1)), ".tif")
    for case in (_jpeg_planes(px[..., :3].copy(), 6),
                 _jpeg_planes(px[..., :3].copy(), 6, (2, 1))):
        assert isinstance(_pil(case), Exception)
        with pytest.raises(ValueError):
            tio.decode_image(case, "case", ".tif")
    rgb = _save(Image.fromarray(px[..., :3].copy()), "JPEG")
    case = _tiff_file(w, h, [rgb] * 3, {
        258: (3, [8] * 3), 259: (3, [7]), 262: (3, [2]), 277: (3, [3]),
        284: (3, [2]), 278: (4, [h])})
    assert isinstance(_pil(case), Exception)
    with pytest.raises(ValueError, match="JPEG"):
        tio.decode_image(case, "case", ".tif")



def _huffman_jpeg(planes, precision=8, restart=0):
    """An extended sequential Huffman JPEG (SOF1) of the (H, W) planes,
    each component 1 x 1, with flat tables that hold every symbol of
    12-bit data: DC categories 0-15 in 5 bits, every AC run / size in 8."""
    h, w = planes[0].shape
    comps, mcux, mcuy = _components(planes, [(1, 1)] * len(planes), 8)
    coefs = [_coefs(c, _QUANT, precision) for c in comps]
    dc_syms = list(range(16))
    ac_syms = [0x00, 0xF0] + [r << 4 | z for r in range(16)
                              for z in range(1, 15)]
    dc_code = {v: (k, 5) for k, v in enumerate(dc_syms)}
    ac_code = {v: (k, 8) for k, v in enumerate(ac_syms)}
    dht = (bytes([0x00]) + bytes([0, 0, 0, 0, 16] + [0] * 11) + bytes(dc_syms)
           + bytes([0x10]) + bytes([0] * 7 + [len(ac_syms)] + [0] * 8)
           + bytes(ac_syms))
    out = _frame_head(0xC1, comps, w, h, precision=precision) + _seg(0xC4,
                                                                      dht)
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    out += _seg(0xDA, bytes([len(comps)]) + b"".join(
        bytes([c.id, 0x00]) for c in comps) + bytes([0, 63, 0]))
    mcus = _order(comps, list(range(len(comps))), mcux, mcuy)
    per = restart or len(mcus)

    def value(v):
        s = abs(v).bit_length()
        return s, (v if v >= 0 else v - 1) & ((1 << s) - 1)
    for k in range(0, len(mcus), per):
        bits, last = [], [0] * len(comps)
        for mcu in mcus[k:k + per]:
            for ci, blk in mcu:
                b = coefs[ci][blk][ZIGZAG]
                s, extra = value(int(b[0]) - last[ci])
                last[ci] = int(b[0])
                bits += [dc_code[s], (extra, s)]
                run = 0
                for kk in range(1, 64):
                    if b[kk] == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.append(ac_code[0xF0])
                        run -= 16
                    s, extra = value(int(b[kk]))
                    bits += [ac_code[run << 4 | s], (extra, s)]
                    run = 0
                if run:
                    bits.append(ac_code[0x00])
        acc = "".join(format(v, f"0{n}b") if n else "" for v, n in bits)
        acc += "1" * (-len(acc) % 8)
        raw = int(acc, 2).to_bytes(len(acc) // 8, "big") if acc else b""
        out += raw.replace(b"\xff", b"\xff\x00")
        if k + per < len(mcus):
            out += bytes([0xFF, 0xD0 + (k // per) % 8])
    return out + b"\xff\xd9"


def _tiff_jpeg12(v, stream):
    h, w = v.shape
    return _tiff_file(w, h, [stream], {258: (3, [12]), 259: (3, [7]),
                                       262: (3, [1]), 277: (3, [1]),
                                       278: (4, [h])})


@pytest.mark.parametrize("size", [(2, 2), (8, 8), (18, 13), (40, 24)])
def test_tiff_jpeg_12bit(size, tmp_path):
    """12-bit grey JPEG strips (SOF1 Huffman and SOF9 arithmetic, as
    libjpeg-turbo's 12-bit decoder reads them), packed two samples to
    three bytes as tif_jpeg.c packs them, read as PIL's I;12. An odd width
    leaves a row's last sample to PIL's uncleared buffer, so there the
    port (which leaves it 0) is held to libtiff's decode into a cleared
    buffer. An 8-bit stream in a 12-bit file, and 12 bits in a plain JPEG
    file, are refused by both."""
    w, h = size
    rng = np.random.default_rng(w * h)
    y, x = np.mgrid[0:h, 0:w]
    v = np.clip(x * 9 + y * 5 + rng.normal(0, 20, (h, w)) + 40, 0, 4095)
    v[:, w // 2:] += 1500  # bright parts too (clipped at 255 by PIL)
    v = np.clip(v, 0, 4095).astype(np.int64)
    for stream in (_huffman_jpeg([v], 12), _huffman_jpeg([v], 12, restart=1),
                   _arith_jpeg([v], precision=12)):
        _check(_tiff_jpeg12(v, stream), ".tif")
        assert isinstance(_pil(stream), Exception)
        with pytest.raises(ValueError, match="12-bit"):
            tio.decode_image(stream, "case", ".jpg")
    odd = v[:, :w - 1] if w > 1 else v
    if odd.shape[1] % 2:
        path = tmp_path / "odd.tif"
        path.write_bytes(_tiff_jpeg12(odd, _huffman_jpeg([odd], 12)))
        ret, cleared = _libtiff_strip(_libtiff(), path, 0)
        assert ret > 0
        stride = (odd.shape[1] * 12 + 7) // 8
        rows = np.frombuffer(cleared, np.uint8).reshape(h, stride)
        bits = np.unpackbits(rows, axis=1)[:, :odd.shape[1] * 12]
        samples = (bits.reshape(h, -1, 12) << np.arange(11, -1, -1)).sum(-1)
        got = tio.decode_image(path.read_bytes(), "case", ".tif")
        np.testing.assert_array_equal(got[..., 0],
                                      np.minimum(samples, 255))
    eight = _tiff_jpeg12(v, _huffman_jpeg([np.minimum(v, 255)], 8))
    assert isinstance(_pil(eight), Exception)
    with pytest.raises(ValueError, match="precision|12-bit|8-bit"):
        tio.decode_image(eight, "case", ".tif")


# ---------------------------- old-style LZW ----------------------------

def _lzw_compat(data: bytes, clear_at=4094) -> bytes:
    """LZW as libtiff before 5.0 wrote it (tif_lzw.c's compat form): codes
    packed least significant bit first, a clear code first, the width
    growing one code later than in new-style LZW."""
    codes = [(256, 9)]
    table = {bytes([i]): i for i in range(256)}
    nxt, width, w = 258, 9, b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], width))
        table[wc] = nxt
        nxt += 1
        if nxt - 1 >= 1 << width and width < 12:
            width += 1
        if nxt >= clear_at:
            codes.append((256, width))
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([byte])
    if w:
        codes.append((table[w], width))
        nxt += 1
        if nxt - 1 >= 1 << width and width < 12:
            width += 1
    codes.append((257, width))
    acc = shift = 0
    for c, n in codes:
        acc |= c << shift
        shift += n
    return acc.to_bytes((shift + 7) // 8, "little")


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (33, 17), (96, 64)])
def test_tiff_old_style_lzw(size):
    """Old-style LZW strips (grey, RGB with the horizontal predictor,
    tables past 512, 1024 and 2048 entries, clears), as libtiff's
    LZWDecodeCompat reads them; cut and corrupted strips: the same image
    or both raise."""
    w, h = size
    rng = np.random.default_rng(w)
    for c, pred in ((1, 1), (3, 1), (3, 2)):
        px = _picture(w, h, c, w + c)
        if c == 3:
            px[rng.random((h, w)) < 0.3] = 0
        raw = px.astype(np.int64)
        if pred == 2:
            raw[:, 1:] = np.diff(raw, axis=1) % 256
        tags = {258: (3, [8] * c), 259: (3, [5]), 262: (3, [1 if c == 1
                                                            else 2]),
                277: (3, [c]), 278: (4, [h]), 317: (3, [pred])}
        for clear_at in (4094, 600):
            data = _lzw_compat(raw.astype(np.uint8).tobytes(), clear_at)
            assert data[0] == 0 and data[1] & 1
            _check(_tiff_file(w, h, [data], tags), ".tif")
    for k in range(12):
        bad = bytearray(data)
        if k < 4:
            bad = bad[:max(2, len(bad) * k // 4)]
        else:
            bad[int(rng.integers(2, len(bad)))] ^= 1 << int(rng.integers(8))
        _same(_tiff_file(w, h, [bytes(bad)], tags), ".tif")


# -------------------------- old-style JPEG (6) -------------------------

def _jpeg_tables(stream: bytes):
    """(quant tables by id, DC and AC tables by id as 16 counts + symbols,
    SOF body, SOS segment, entropy-coded data) of a JPEG PIL wrote."""
    q, dc, ac, sof, sos = {}, {}, {}, None, None
    for m, v in _jpeg_segments(stream):
        body = v[4:]
        if m == 0xDB:
            for i in range(0, len(body), 65):
                q[body[i] & 15] = body[i + 1:i + 65]
        elif m == 0xC4:
            i = 0
            while i < len(body):
                n = sum(body[i + 1:i + 17])
                (ac if body[i] >> 4 else dc)[body[i] & 15] = \
                    body[i + 1:i + 17 + n]
                i += 17 + n
        elif m == 0xC0:
            sof = body
        elif m == 0xDA:
            sos = v
    data = sos[2 + (sos[2] << 8 | sos[3]):]
    return q, dc, ac, sof, sos, data.removesuffix(b"\xff\xd9")


def _ojpeg(px, form, photometric=None, sub=2, rows=None, restart_rows=0,
           extra=None):
    """An old-style JPEG TIFF of (H, W) grey or (H, W, 3) RGB pixels that PIL
    encodes (`sub` its JPEG subsampling): `form` "jif" (a whole stream,
    513 / 514 on it, the strip on it too), "jif-header" (513 / 514 on the
    header, the strip on the scan data) or "tables" (519-521, strips of
    `rows` rows, each a restart interval of PIL's `restart_rows`)."""
    grey = px.ndim == 2
    h, w = px.shape[:2]
    spp = 1 if grey else 3
    kw = {} if grey else {"subsampling": sub}
    if restart_rows:
        kw["restart_marker_rows"] = restart_rows
    stream = _save(Image.fromarray(px), "JPEG", quality=90, **kw)
    hs, vs = (1, 1) if grey else {0: (1, 1), 1: (2, 1), 2: (2, 2)}[sub]
    tags = {258: (3, [8] * spp), 259: (3, [6]),
            262: (3, [photometric if photometric is not None
                      else 1 if grey else 6]),
            277: (3, [spp]), 278: (4, [rows or h]), **(extra or {})}
    if not grey and 530 not in tags:
        tags[530] = (3, [hs, vs])
    if form == "jif":
        tags.update({513: (4, [8]), 514: (4, [len(stream)])})
        return _tiff_file(w, h, [stream], tags), stream
    q, dc, ac, sof, sos, data = _jpeg_tables(stream)
    if form == "jif-header":
        head = stream[:len(stream) - len(data) - 2]
        tags.update({513: (4, [8 + len(data)]), 514: (4, [len(head)])})
        return _strips_first(w, h, [data], head, tags), stream
    parts = [data]
    if restart_rows:
        import re
        parts = re.split(rb"\xff[\xd0-\xd7]", data)
    comp = [(sof[8 + 3 * k], sos[6 + 2 * k]) for k in range(spp)]
    blobs = []
    for k, (tq, tdta) in enumerate(comp):
        blobs += [q[tq], dc[tdta >> 4], ac[tdta & 15]]
    at = 8 + sum(len(p) for p in parts)
    offs = []
    for b in blobs:
        offs.append(at)
        at += len(b)
    tags.update({512: (3, [1]), 519: (4, offs[0::3]), 520: (4, offs[1::3]),
                 521: (4, offs[2::3])})
    return _strips_first(w, h, parts, b"".join(blobs), tags), stream


def _strips_first(w, h, strips, tail, tags):
    """A TIFF whose strips are `strips`, with `tail` stored right after
    them (outside every strip)."""
    data = _tiff_file(w, h, strips + [tail], tags)
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    out = bytearray(data)
    for k in range(n):
        e = ifd + 2 + 12 * k
        tag, _, count = struct.unpack_from("<HHI", data, e)
        if tag in (273, 279):
            values = struct.unpack_from(f"<{count}I", data,
                                        struct.unpack_from("<I", data,
                                                           e + 8)[0])
            struct.pack_into("<I", out, e + 4, len(strips))
            if len(strips) == 1:
                struct.pack_into("<I", out, e + 8, values[0])
    return bytes(out)


@pytest.mark.parametrize("size", [(1, 1), (16, 16), (37, 21), (64, 48)])
@pytest.mark.parametrize("form", ["jif", "jif-header", "tables"])
def test_tiff_old_style_jpeg(size, form):
    """Both forms of tif_ojpeg.c: YCbCr 4:2:0, 4:2:2 and 4:4:4 (decoded raw
    and converted by libtiff), PhotometricInterpretation 2 (libtiff reads
    it as YCbCr), grey in both photometric interpretations."""
    w, h = size
    px = _picture(w, h, 3, w + h)
    for sub in (2, 1, 0):
        _check(_ojpeg(px, form, sub=sub)[0], ".tif")
    _check(_ojpeg(px, form, photometric=2)[0], ".tif")
    for photometric in (1, 0):
        _check(_ojpeg(px[..., 1].copy(), form, photometric)[0], ".tif")


def test_tiff_old_style_jpeg_strips_restarts_and_refusals():
    """Strips joined by RST markers (with JPEGRestartInterval and
    without), a stream with restart intervals, the stream's sampling over
    a YCbCrSubsampling tag that disagrees; a progressive stream and
    missing tables refused by both."""
    w, h = 37, 48
    px = _picture(w, h, 3, 5)
    for extra in ({515: (3, [3])}, {}):
        _check(_ojpeg(px, "tables", rows=16, restart_rows=1,
                      extra=extra)[0], ".tif")
    _check(_ojpeg(px[..., 0].copy(), "tables", rows=8, restart_rows=1)[0],
           ".tif")
    _check(_ojpeg(px, "jif", restart_rows=1)[0], ".tif")
    _check(_ojpeg(px, "jif", sub=2, extra={530: (3, [1, 1])})[0], ".tif")
    _check(_ojpeg(px, "jif", sub=0, extra={530: (3, [2, 2])})[0], ".tif")
    prog = _save(Image.fromarray(px), "JPEG", progressive=True)
    refused = [_tiff_file(w, h, [prog], {
        258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]), 277: (3, [3]),
        278: (4, [h]), 513: (4, [8]), 514: (4, [len(prog)])})]
    data, _ = _ojpeg(px, "tables")
    (ifd,) = struct.unpack_from("<I", data, 4)
    refused.append(_patch_tag_id(data, 519, 999))
    for case in refused:
        assert isinstance(_pil(case), Exception)
        with pytest.raises(ValueError, match="old-style JPEG"):
            tio.decode_image(case, "case", ".tif")


def test_tiff_old_style_and_12bit_jpeg_cut_and_corrupt():
    """Old-style JPEG (both forms) and 12-bit JPEG strips with cut and
    corrupted data: the same image or both raise (an even width: a 12-bit
    row's odd last sample is left to PIL's uncleared buffer)."""
    px = _picture(37, 48, 3, 5)
    v = np.clip(px[:, :36, 0].astype(np.int64) * 9, 0, 4095)
    outcomes = []
    for k, data in enumerate((_ojpeg(px, "jif")[0],
                              _ojpeg(px, "tables", rows=16,
                                     restart_rows=1)[0],
                              _tiff_jpeg12(v, _huffman_jpeg([v], 12)))):
        (ifd,) = struct.unpack_from("<I", data, 4)
        cases = [data[:8 + cut] + bytes(ifd - 8 - cut) + data[ifd:]
                 for cut in (10, 300)]
        outcomes += [_same(c, ".tif") for c in cases + _flips(
            data, 20, k, 8, ifd)]
    assert any(outcomes) and not all(outcomes)


def _patch_tag_id(data: bytes, tag: int, new: int) -> bytes:
    """A little-endian TIFF with one tag renumbered (so that it is
    missing); the IFD stays sorted enough for the readers."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    out = bytearray(data)
    for k in range(n):
        e = ifd + 2 + 12 * k
        if struct.unpack_from("<H", data, e)[0] == tag:
            struct.pack_into("<H", out, e, new)
    return bytes(out)


# ------------------ refused by both: TIFF WebP, JPEG 2000 ------------------

@pytest.mark.parametrize("comp,fmt,name", [(50001, "WEBP", "WebP"),
                                           (34712, "JPEG2000", "JPEG 2000")])
def test_tiff_webp_and_jpeg2000_refused_by_both(comp, fmt, name):
    """PIL's libtiff has no WebP or JPEG 2000 codec: a strip holding a real
    bitstream (PIL's own WebP or JPEG 2000 save of the picture) is refused
    by PIL, and by the port by name. (PIL cannot write these TIFFs here:
    its WebP TIFF save fails in the encoder.)"""
    w, h = 17, 11
    px = _picture(w, h, 3, comp)
    stream = _save(Image.fromarray(px), fmt)
    if fmt == "WEBP":
        # the TIFF WebP codec stores the VP8 / VP8L data in a RIFF container
        assert stream[:4] == b"RIFF"
    for photometric in (2, 6):
        case = _tiff_file(w, h, [stream], {
            258: (3, [8] * 3), 259: (3, [comp]), 262: (3, [photometric]),
            277: (3, [3]), 278: (4, [h])})
        assert isinstance(_pil(case), Exception)
        with pytest.raises(ValueError, match=name):
            tio.decode_image(case, "case", ".tif")


# ------------------------------ fixtures ------------------------------

def fixture_files() -> dict:
    """The committed fixtures: one small file per codec family (at most
    64 x 64), PIL's decode of each committed beside it as PNG."""
    w, h = 48, 32
    rng = np.random.default_rng(19)
    px = _picture(w, h, 3, 19)
    bil = _bilevel(64, 40, 19)
    v12 = np.clip(_picture(w, h, 1, 7)[..., 0].astype(np.int64) * 3
                  + rng.integers(0, 40, (h, w)), 0, 4095)
    v12[:, w // 2:] += 2000
    raw = px.astype(np.int64)
    raw[:, 1:] = np.diff(raw, axis=1) % 256
    rgb = {258: (3, [8] * 3), 262: (3, [2]), 277: (3, [3]), 278: (4, [h])}
    planes = _rgb_planes(w, h, 19)
    f420 = [(2, 2), (1, 1), (1, 1)]
    return {
        "ccitt_mh_fill2.tif": _save(bil, "TIFF", compression="tiff_ccitt",
                                    tiffinfo={266: 2}),
        "ccitt_g3_1d_eolfill.tif": _save(bil, "TIFF", compression="group3",
                                         tiffinfo={292: 4}),
        "ccitt_g3_2d_whiteiszero.tif": _patch_tag(_save(
            bil, "TIFF", compression="group3", tiffinfo={292: 1, 278: 16}), 262, 0),
        "ccitt_g4.tif": _save(bil, "TIFF", compression="group4"),
        "lzma_pred.tif": _save(Image.fromarray(px), "TIFF", compression="lzma",
                               tiffinfo={317: 2}),
        # steps of 32: a compressed block (Huffman literals, sequences)
        "zstd_rgba.tif": _save(Image.fromarray(
            (_picture(w, h, 4, 3) // 32 * 32).astype(np.uint8)), "TIFF",
            compression="zstd"),
        "lzw_old_pred.tif": _tiff_file(w, h, [_lzw_compat(raw.astype(
            np.uint8).tobytes())], {**rgb, 259: (3, [5]), 317: (3, [2])}),
        "grey12_deflate.tif": _tiff12(v12, 8, rows_per_strip=8),
        "jpeg12.tif": _tiff_jpeg12(v12, _huffman_jpeg([v12], 12)),
        "planar_ycbcr_deflate.tif": _planar_ycbcr(px, 8, (1, 1)),
        "planar_ycbcr_raw.tif": _planar_ycbcr(px, 1, (2, 2)),
        "jpeg_planar_tables.tif": _jpeg_planes(px, 2, tables=True),
        "ojpeg_jif.tif": _ojpeg(px, "jif")[0],
        "ojpeg_tables_strips.tif": _ojpeg(px, "tables", rows=16,
                                          restart_rows=1)[0],
        "arith_420_restart.jpg": _arith_jpeg(planes, f420, restart=2),
        "arith_progressive.jpg": _arith_jpeg(planes, f420, PROGRESSION,
                                             progressive=True),
        "lossless_rgb_pred6_pt1.jpg": _lossless_jpeg(
            list(np.moveaxis(px, -1, 0)), 6, 1, rgb=True),
    }


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


def test_committed_codecs_fixtures_equal_pil_and_their_pngs():
    """Each committed file decodes in the port as in PIL and equals the
    PNG of PIL's decode beside it (what chip_smoke.py checks without
    PIL); the set is the one fixture_files makes, under 300 KB."""
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if not p.name.endswith(".png"))
    assert names == sorted(fixture_files())
    total = 0
    for name in names:
        data = (FIXTURES / name).read_bytes()
        png = FIXTURES / (name + ".png")
        total += len(data) + png.stat().st_size
        got = tio.load_image(FIXTURES / name)
        assert got.shape[0] <= 64 and got.shape[1] <= 64
        np.testing.assert_array_equal(got, tio.load_image(png), err_msg=name)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)
    assert total < 300_000


def print_decode_times():
    """Each committed fixture's host decode time (best of 3), in ms."""
    for path in sorted(FIXTURES.iterdir()):
        if path.name.endswith(".png"):
            continue
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            tio.load_image(path)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{path.name}: {min(times):.2f} ms")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
    else:
        print_decode_times()
