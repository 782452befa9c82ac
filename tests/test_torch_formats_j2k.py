"""JPEG 2000 in the port (assets/jp2.py over j2k_codestream.py, j2k_t2.py,
j2k_t1.py and j2k_recon.py) against PIL 12.1's decode through its bundled
OpenJPEG 2.5.4, which the JAX package's load_image uses:

  - every file decodes to ``np.asarray(Image.open(p).convert("RGBA"))``
    bit for bit, or raises where PIL raises: files PIL writes (L, LA, RGB,
    RGBA and I;16; 5/3 and 9/7, with and without the colour transform;
    tiles and image / tile offsets; 1-6 resolutions; layers by rate and by
    dB; code-block and precinct sizes; the five progression orders; signed
    samples; PLT and comments) and files written here through the
    libopenjp2 that PIL bundles (ctypes; PIL's save exposes none of
    these): every code-block style bit alone and combined, SOP and EPH,
    POC, RGN, tile-parts, TLM, guard bits, precisions of 1-16 bits signed
    and unsigned, subsampled components;
  - what no encoder here writes is built from those files: PPM and PPT
    (the packet headers of an SOP + EPH codestream moved into the
    markers), JP2 files around a codestream with ``pclr`` (P, PA, RGBA
    entries, repeated colours), ``cmap``, ``cdef``, ``colr`` sYCC / eYCC /
    CMYK / grey / ICC, ``res``, a ``jpx`` brand and a ``bpcc`` box;
  - JPEG 2000 elements inside ICNS;
  - cut and bit-flipped codestreams: the same image as PIL's (OpenJPEG
    decodes many in part) or both raise;
  - the committed fixtures in tests/data/formats_j2k, each beside PIL's
    decode of it as PNG, and the courtyard's 12 textures as JP2
    (tests/data/formats_j2k/courtyard) against the digests of PIL's
    decodes that chip_smoke.py holds the port to on the card's machine,
    which has no PIL;
  - render/scenebuild._load_texture_images on JP2 maps against the JAX
    package's.

``PYTHONPATH=. python tests/test_torch_formats_j2k.py --write-fixtures``
regenerates tests/data/formats_j2k; without the flag it prints each
fixture's decode time on the host. One thread, no card."""

import ctypes
import glob
import hashlib
import os
import struct
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import PIL
import pytest
import torch
from PIL import Image

from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.render import scenebuild as tsb
from test_torch_formats import _picture, _pil, _save

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
FIXTURES = Path(__file__).resolve().parent / "data" / "formats_j2k"
COURTYARD = FIXTURES / "courtyard"
SIZES = ((1, 1), (7, 5), (33, 17))


def _same(data: bytes, suffix: str = ".jp2"):
    """The port's outcome is PIL's: the same image, or both raise."""
    want = _pil(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            tio.decode_image(data, "case", suffix)
        return False
    got = tio.decode_image(data, "case", suffix)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return True


def _planes(w, h, c, prec=8, sgnd=0, seed=0):
    """c integer planes of `prec` bits (signed: offset by half the range)."""
    a = _picture(w, h, c, seed).astype(np.int64)
    rng = np.random.default_rng(seed)
    out = []
    for k in range(c):
        p = a[..., k]
        if prec > 8:
            p = (p << (prec - 8)) + rng.integers(0, 1 << (prec - 8), p.shape)
        elif prec < 8:
            p = p >> (8 - prec)
        if sgnd:
            p = p - (1 << (prec - 1))
        out.append(p.astype(np.int32))
    return out


# -------------- libopenjp2 (PIL's own) through ctypes ---------------

class _CmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                 "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("x0", "y0", "x1", "y1", "numcomps")] + [
        ("color_space", ctypes.c_int),
        ("comps", ctypes.POINTER(_ImageComp)), ("icc", ctypes.c_void_p),
        ("icc_len", ctypes.c_uint32)]


# byte offsets in opj_cparameters_t (openjpeg.h, 2.5; 18720 bytes on
# x86-64), checked against opj_set_default_encoder_parameters' defaults
_OFF = dict(tile_size_on=0, cp_tx0=4, cp_ty0=8, cp_tdx=12, cp_tdy=16,
            cp_disto_alloc=20, csty=48, prog_order=52, POC=56,
            numpocs=4792, tcp_numlayers=4796, tcp_rates=4800,
            numresolution=5600, cblockw_init=5604, cblockh_init=5608,
            mode=5612, irreversible=5616, roi_compno=5620, roi_shift=5624,
            res_spec=5628, prcw_init=5632, prch_init=5764,
            image_offset_x0=18188, image_offset_y0=18192,
            subsampling_dx=18196, decod_format=18204, tp_on=18696,
            tp_flag=18697, tcp_mct=18698)
_PARAMS_SIZE = 18720
_POC_SIZE = 148
_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
_LIB = None


def _libopenjp2():
    global _LIB
    if _LIB is None:
        path = glob.glob(str(Path(PIL.__file__).parent.parent / "pillow.libs"
                             / "libopenjp2-*.so.2.5.4"))
        if not path:
            pytest.fail("PIL's bundled libopenjp2 2.5.4 is not found")
        lib = ctypes.CDLL(path[0])
        vp = ctypes.c_void_p
        lib.opj_image_create.restype = vp
        lib.opj_create_compress.restype = vp
        lib.opj_stream_create_default_file_stream.restype = vp
        lib.opj_stream_create_default_file_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int]
        par = (ctypes.c_char * _PARAMS_SIZE)()
        lib.opj_set_default_encoder_parameters(par)
        ints = np.frombuffer(bytes(par), np.int32)
        assert ints[_OFF["numresolution"] // 4:][:3].tolist() == [6, 64, 64]
        assert ints[_OFF["roi_compno"] // 4] == -1
        assert ints[_OFF["subsampling_dx"] // 4:][:4].tolist() == [1, 1, -1, -1]
        _LIB = lib
    return _LIB


def _opj(planes, *, prec=8, sgnd=0, sub=None, size=None, origin=(0, 0),
         tile=None, tile_origin=(0, 0), numres=None, cblk=(64, 64), mode=0,
         irreversible=False, mct=None, layers=None, prog="LRCP",
         precincts=None, sop=False, eph=False, roi=None, tp=None, pocs=None,
         extra=(), jp2=False, colour=None) -> bytes:
    """A codestream (or JP2 file) written by libopenjp2 from integer planes
    at each component's own size; `mode` is the code-block style bits
    (1 BYPASS, 2 RESET, 4 TERMALL, 8 VSC, 16 PTERM, 32 SEGSYM)."""
    lib = _libopenjp2()
    vp = ctypes.c_void_p
    n = len(planes)
    sub = sub or [(1, 1)] * n
    precs = prec if isinstance(prec, (list, tuple)) else [prec] * n
    w, h = size or (planes[0].shape[1] * sub[0][0],
                    planes[0].shape[0] * sub[0][1])
    if numres is None:
        m = min(w, h, *(tile or ()))
        numres = max(1, min(6, m.bit_length()))
    parms = (_CmptParm * n)()
    for i, p in enumerate(planes):
        parms[i].dx, parms[i].dy = sub[i]
        parms[i].h, parms[i].w = p.shape
        parms[i].x0 = -(-origin[0] // sub[i][0])
        parms[i].y0 = -(-origin[1] // sub[i][1])
        parms[i].prec = parms[i].bpp = precs[i]
        parms[i].sgnd = sgnd
    space = colour if colour is not None else (1 if n >= 3 else 2)
    img_p = lib.opj_image_create(ctypes.c_uint32(n), parms, ctypes.c_int(space))
    img = ctypes.cast(img_p, ctypes.POINTER(_Image)).contents
    img.x0, img.y0 = origin
    img.x1, img.y1 = origin[0] + w, origin[1] + h
    for i, p in enumerate(planes):
        d = np.ascontiguousarray(p, np.int32)
        ctypes.memmove(img.comps[i].data, d.ctypes.data, d.nbytes)
    par = (ctypes.c_char * _PARAMS_SIZE)()
    lib.opj_set_default_encoder_parameters(par)

    def put(name, v, i=0, kind=ctypes.c_int32):
        kind.from_buffer(par, _OFF[name] + 4 * i).value = v

    put("numresolution", numres)
    put("cblockw_init", cblk[0])
    put("cblockh_init", cblk[1])
    put("mode", mode)
    put("irreversible", int(irreversible))
    put("prog_order", _PROG[prog])
    put("image_offset_x0", origin[0])
    put("image_offset_y0", origin[1])
    if tile:
        put("tile_size_on", 1)
        put("cp_tdx", tile[0])
        put("cp_tdy", tile[1])
        put("cp_tx0", tile_origin[0])
        put("cp_ty0", tile_origin[1])
    rates = layers or [0.0]
    put("tcp_numlayers", len(rates))
    put("cp_disto_alloc", 1)
    for i, r in enumerate(rates):
        put("tcp_rates", r, i, ctypes.c_float)
    csty = (2 if sop else 0) | (4 if eph else 0)
    if precincts:
        csty |= 1
        put("res_spec", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            put("prcw_init", pw, i)
            put("prch_init", ph, i)
    put("csty", csty)
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if tp:
        ctypes.c_char.from_buffer(par, _OFF["tp_on"]).value = b"\1"
        ctypes.c_char.from_buffer(par, _OFF["tp_flag"]).value = tp.encode()
    ctypes.c_char.from_buffer(par, _OFF["tcp_mct"]).value = bytes(
        [int(mct if mct is not None else n >= 3)])
    for k, (r0, c0, l1, r1, c1, order) in enumerate(pocs or ()):
        base = _OFF["POC"] + _POC_SIZE * k
        for j, v in enumerate((r0, c0, l1, r1, c1, 0, 0, 0, _PROG[order],
                               _PROG[order])):
            ctypes.c_uint32.from_buffer(par, base + 4 * j).value = v
        ctypes.memmove(ctypes.addressof(par) + base + 40,
                       order.encode() + b"\0", 5)
        ctypes.c_uint32.from_buffer(par, base + 48).value = 1  # tile 1
    if pocs:
        put("numpocs", len(pocs))
    codec = lib.opj_create_compress(ctypes.c_int(2 if jp2 else 0))
    ok = lib.opj_setup_encoder(vp(codec), par, vp(img_p))
    if ok and extra:
        opts = (ctypes.c_char_p * (len(extra) + 1))(
            *[e.encode() for e in extra], None)
        ok = lib.opj_encoder_set_extra_options(vp(codec), opts)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.j2k")
        st = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (ok and lib.opj_start_compress(vp(codec), vp(img_p), vp(st))
              and lib.opj_encode(vp(codec), vp(st))
              and lib.opj_end_compress(vp(codec), vp(st)))
        lib.opj_stream_destroy(vp(st))
        lib.opj_destroy_codec(vp(codec))
        lib.opj_image_destroy(vp(img_p))
        data = Path(path).read_bytes()
    assert ok, "libopenjp2 refused to encode"
    return data


# -------------------- files no encoder here writes --------------------

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", len(body) + 8, kind) + body


def _jp2(stream, nc, w, h, bpc=7, colr=(1, 16), extra=(), brand=b"jp2 ",
         before=()) -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr, colr
    (method 1 with an EnumCS, or 2 with ICC bytes, or None), `extra`
    boxes), jp2c."""
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    c = b"" if colr is None else _box(b"colr", bytes([colr[0], 0, 0]) + (
        struct.pack(">I", colr[1]) if colr[0] == 1 else colr[1]))
    return (_box(b"jP  ", b"\r\n\x87\n")
            + _box(b"ftyp", brand + b"\0\0\0\0" + brand) + b"".join(before)
            + _box(b"jp2h", ihdr + c + b"".join(extra))
            + _box(b"jp2c", stream))


def _pclr(entries, depths) -> bytes:
    body = struct.pack(">HB", len(entries), len(depths)) + bytes(depths)
    for e in entries:
        for v, d in zip(e, depths):
            body += int(v).to_bytes(((d & 0x7F) + 8) // 8, "big")
    return _box(b"pclr", body)


def _cmap(n) -> bytes:
    return _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                  for i in range(n)))


def _cdef(defs) -> bytes:
    return _box(b"cdef", struct.pack(">H", len(defs)) + b"".join(
        struct.pack(">HHH", *d) for d in defs))


def _res() -> bytes:
    return _box(b"res ", _box(b"resc", struct.pack(">HHHHBB", 30, 1, 30, 1,
                                                   2, 2)))


def _tile_parts(cs: bytes):
    """(main header, [((Isot, TPsot, TNsot), tile-part header markers,
    data)]) of a codestream."""
    pos = 2
    while struct.unpack_from(">H", cs, pos)[0] != 0xFF90:
        pos += 2 + struct.unpack_from(">H", cs, pos + 2)[0]
    main, parts = cs[:pos], []
    while struct.unpack_from(">H", cs, pos)[0] == 0xFF90:
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", cs, pos + 4)
        q, head = pos + 12, b""
        while struct.unpack_from(">H", cs, q)[0] != 0xFF93:
            size = struct.unpack_from(">H", cs, q + 2)[0]
            head += cs[q:q + 2 + size]
            q += 2 + size
        parts.append(((isot, tpsot, tnsot), head, cs[q + 2:pos + psot]))
        pos += psot
    return main, parts


def _packets(data: bytes):
    """[(header with its EPH, SOP + body)] of a tile-part whose packets
    all carry SOP and EPH (neither can occur inside a header or inside
    entropy-coded data)."""
    sops, i = [], data.find(b"\xff\x91")
    while i >= 0:
        sops.append(i)
        i = data.find(b"\xff\x91", i + 6)
    out = []
    for k, s in enumerate(sops):
        e = data.index(b"\xff\x92", s + 6) + 2
        nxt = sops[k + 1] if k + 1 < len(sops) else len(data)
        out.append((data[s + 6:e], data[s:s + 6] + data[e:nxt]))
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def _move_headers(cs: bytes, where: str) -> bytes:
    """The SOP + EPH codestream `cs` with its packet headers moved into
    PPT markers (each tile-part's own) or one PPM marker (Nppm per
    tile-part), the SOP markers and bodies left in the tile data."""
    main, parts = _tile_parts(cs)
    out, ppm, zppt = [], b"", {}
    for (isot, tpsot, tnsot), head, data in parts:
        pk = _packets(data)
        heads = b"".join(hd for hd, _ in pk)
        if where == "ppt":  # Zppt counts on over a tile's parts
            for k in range(max(1, -(-len(heads) // 60000))):
                z = zppt.get(isot, 0)
                zppt[isot] = z + 1
                head += _segment(0xFF61, bytes([z])
                                 + heads[k * 60000:(k + 1) * 60000])
        else:
            ppm += struct.pack(">I", len(heads)) + heads
        tpart = head + b"\xff\x93" + b"".join(b for _, b in pk)
        out.append(struct.pack(">HHHIBB", 0xFF90, 10, isot, 12 + len(tpart),
                               tpsot, tnsot) + tpart)
    if where == "ppm":
        main += _segment(0xFF60, b"\0" + ppm)
    return main + b"".join(out) + b"\xff\xd9"


def _icns(elements) -> bytes:
    body = b"".join(t + struct.pack(">I", len(d) + 8) + d for t, d in elements)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


# ------------------------------ PIL's saves ------------------------------

PIL_OPTIONS = [
    {}, {"irreversible": True}, {"no_jp2": True, "irreversible": True},
    {"tile_size": (16, 16)},
    {"tile_offset": (3, 2), "offset": (5, 7), "tile_size": (16, 12)},
    {"offset": (3, 1), "irreversible": True},
    {"quality_mode": "dB", "quality_layers": [30, 40, 50]},
    {"quality_mode": "rates", "quality_layers": [80, 20, 5],
     "irreversible": True},
    {"progression": "RPCL", "precincts": [(16, 16), (32, 32)],
     "num_resolutions": 3},
    {"progression": "PCRL", "precincts": [(32, 32), (16, 16), (8, 8)],
     "num_resolutions": 4, "codeblock_size": (8, 8)},
    {"progression": "CPRL", "num_resolutions": 2, "codeblock_size": (4, 16)},
    {"progression": "RLCP", "quality_mode": "rates",
     "quality_layers": [10, 3]},
    {"num_resolutions": 1}, {"mct": 0}, {"mct": 1, "irreversible": True},
    {"plt": True, "comment": "a comment"}, {"signed": True}]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_pil_saves(size, mode):
    """PIL's own JPEG 2000 saves under every option it takes, at sizes
    that are no multiple of a tile, precinct or code-block."""
    w, h = size
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    a = _picture(w, h, c, w * h + c)
    if mode == "I;16":
        im = Image.frombytes("I;16", (w, h), (a[..., 0].astype("<u2") * 97
                                              ).tobytes())
    else:
        im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
    checked = 0
    for kw in PIL_OPTIONS:
        try:
            data = _save(im, "JPEG2000", **kw)
        except (OSError, ValueError):
            continue  # a size or option PIL's encoder refuses
        checked += _same(data)
    assert checked >= len(PIL_OPTIONS) - 6


# -------------------- libopenjp2: styles and markers --------------------

STYLES = [1, 2, 4, 8, 16, 32, 1 | 4, 1 | 32, 1 | 4 | 32, 2 | 8, 4 | 16, 63]


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("irreversible", [False, True])
def test_codeblock_styles(style, irreversible):
    """Every code-block style bit alone and combined (BYPASS, RESET,
    TERMALL, VSC, PTERM, SEGSYM), 5/3 and 9/7, one and three components,
    small code-blocks and several layers on the 9/7 path."""
    for (w, h), c in (((7, 5), 1), ((33, 17), 3)):
        planes = _planes(w, h, c, seed=w + style)
        assert _same(_opj(planes, mode=style, irreversible=irreversible,
                          cblk=(16, 16) if w > 16 else (64, 64),
                          layers=[20, 5, 1] if irreversible else None))


MARKERS = {
    "sop": dict(sop=True), "eph": dict(eph=True),
    "sop_eph_layers": dict(sop=True, eph=True, layers=[10, 2]),
    "tile_parts_r": dict(tp="R"), "tile_parts_l": dict(tp="L", layers=[10, 1]),
    "tile_parts_c": dict(tp="C", tile=(16, 16)),
    "tlm": dict(extra=["TLM=YES"]),
    "tlm_plt_tiles": dict(extra=["PLT=YES", "TLM=YES"], tile=(16, 16)),
    "guard_bits_0": dict(extra=["GUARD_BITS=0"]),
    "guard_bits_4_97": dict(extra=["GUARD_BITS=4"], irreversible=True),
    "rgn_53": dict(roi=(0, 3)), "rgn_97": dict(roi=(1, 7), irreversible=True,
                                               layers=[20]),
    "tile_and_image_offsets": dict(tile=(8, 8), tile_origin=(1, 2),
                                   origin=(3, 5)),
    "six_resolutions_4x4_blocks": dict(numres=6, cblk=(4, 4)),
    "one_resolution": dict(numres=1),
    "rpcl_precincts": dict(prog="RPCL", precincts=[(4, 4), (3, 3), (3, 4)],
                           numres=3, layers=[20, 4]),
    "cprl_precincts": dict(prog="CPRL", precincts=[(4, 4), (3, 3), (3, 4)],
                           numres=3, layers=[20, 4], irreversible=True),
    "pcrl_precincts_tiles": dict(prog="PCRL", precincts=[(4, 4), (3, 3)],
                                 numres=2, tile=(20, 20), layers=[20, 4]),
    "jp2": dict(jp2=True), "jp2_97_no_mct": dict(jp2=True, mct=0,
                                                 irreversible=True)}


@pytest.mark.parametrize("name", sorted(MARKERS))
def test_markers_and_progressions(name):
    """SOP, EPH, tile-parts, TLM, PLT, guard bits, RGN (ROI maxshift),
    tiles with offsets, 0-5 decomposition levels, the progressions with
    precincts, JP2 files libopenjp2 writes."""
    kw = MARKERS[name]
    for (w, h) in ((33, 17), (64, 40)):
        planes = _planes(w, h, 3, seed=len(name) + w)
        try:
            data = _opj(planes, **{"numres": 3, **kw})
        except AssertionError:
            assert (w, h) == (33, 17), name  # too many levels for 33 x 17
            continue
        assert _same(data, ".j2k")
        break


POCS = [
    [(0, 0, 1, 2, 3, "LRCP"), (2, 0, 1, 3, 3, "RLCP")],
    [(0, 0, 2, 3, 1, "RLCP"), (0, 1, 2, 3, 3, "LRCP")],
    [(0, 0, 1, 3, 3, "RPCL"), (0, 0, 2, 3, 3, "CPRL")],
    [(1, 0, 2, 3, 3, "PCRL"), (0, 0, 2, 3, 3, "LRCP")]]


@pytest.mark.parametrize("poc", range(len(POCS)))
def test_poc(poc):
    """POC markers: several progressions, each over a range of layers,
    resolutions and components, packets already read skipped."""
    for (w, h) in ((7, 5), (33, 17), (64, 40)):
        planes = _planes(w, h, 3, seed=poc + w)
        for kw in ({}, {"irreversible": True,
                        "precincts": [(4, 4), (4, 4), (5, 5)]}):
            data = _opj(planes, numres=3, pocs=POCS[poc], layers=[20, 4], **kw)
            assert b"\xff\x5f" in data
            assert _same(data, ".j2k")


@pytest.mark.parametrize("prec", [1, 2, 5, 9, 12, 16])
def test_precisions_and_signed(prec):
    """Precisions of 1-16 bits, signed and unsigned, on 1-4 components
    (L or I;16, LA in a JP2 file, RGB, RGBA), 5/3 and 9/7."""
    for sgnd in (0, 1):
        for c in (1, 2, 3, 4):
            for irreversible in (False, True):
                planes = _planes(17, 9, c, prec, sgnd, seed=prec + c)
                assert _same(_opj(planes, prec=prec, sgnd=sgnd, numres=3,
                                  irreversible=irreversible, jp2=c == 2))


SUBSAMPLING = [[(1, 1), (2, 2), (2, 2)], [(1, 1), (2, 1), (2, 1)],
               [(1, 1), (1, 2), (1, 2)], [(2, 2), (2, 2), (2, 2)],
               [(1, 1), (3, 2), (3, 2)], [(1, 1), (2, 2), (2, 2), (1, 1)],
               [(2, 1), (1, 1), (1, 1)], [(1, 1), (2, 2)], [(2, 2)]]


@pytest.mark.parametrize("sub", range(len(SUBSAMPLING)))
def test_subsampled_components(sub):
    """Components at their own subsampled sizes: PIL's guess of sYCC where
    only components after the first are subsampled, its nearest-neighbour
    placement with its row and plane strides, tiles and offsets, and its
    refusal of the modes whose unpacker takes no subsampling."""
    subs = SUBSAMPLING[sub]
    for (w, h) in ((7, 5), (33, 17), (1, 1), (2, 3)):
        a = _picture(w, h, len(subs), w + h).astype(np.int32)
        planes = [np.ascontiguousarray(a[::dy, ::dx, k])
                  for k, (dx, dy) in enumerate(subs)]
        for kw in (dict(), dict(irreversible=True), dict(jp2=True, colour=3),
                   dict(tile=(16, 16)), dict(origin=(1, 1))):
            try:
                data = _opj(planes, sub=subs, size=(w, h), mct=0, **kw)
            except AssertionError:
                continue  # a tile or offset libopenjp2 refuses for 1 x 1
            _same(data)


@pytest.mark.parametrize("where", ["ppt", "ppm"])
def test_ppm_and_ppt(where):
    """Packet headers moved into PPT markers (per tile-part) or one PPM
    marker: the image PIL gives, which is the image of the stream before
    the move."""
    for (w, h) in ((7, 5), (33, 17), (64, 40)):
        planes = _planes(w, h, 3, seed=w)
        for kw in ({}, {"layers": [20, 5, 1], "irreversible": True},
                   {"tile": (16, 16)}, {"tp": "R", "layers": [10, 2]}):
            cs = _opj(planes, sop=True, eph=True, numres=3, **kw)
            moved = _move_headers(cs, where)
            assert moved != cs
            assert _same(moved, ".j2k")
            np.testing.assert_array_equal(_pil(moved), _pil(cs))


def _header_cases(irreversible: bool) -> dict:
    """A codestream with markers inserted that libopenjp2 does not write:
    COC and QCC (after COD / QCD, and a COC before COD, which COD
    overrides in OpenJPEG), CRG, COM, an unknown marker, a COC and a COM
    in the tile-part header; and markers out of place or malformed."""
    cs = _opj(_planes(33, 17, 3, seed=4), numres=3, irreversible=irreversible,
              layers=[20, 4] if irreversible else None)
    pos, seg = 2, {}
    while struct.unpack_from(">H", cs, pos)[0] != 0xFF90:
        marker, size = struct.unpack_from(">HH", cs, pos)
        seg.setdefault(marker, (cs[pos + 4:pos + 2 + size], pos + 2 + size))
        pos += 2 + size
    sot = pos
    cod, qcd, siz_end = seg[0xFF52][0], seg[0xFF5C][0], seg[0xFF51][1]
    coc = bytes([1, cod[0] & 1]) + cod[5:]

    def main(at, *markers):
        return cs[:at] + b"".join(_segment(m, b) for m, b in markers) + cs[at:]

    def tile(marker, body):
        d = cs[:sot + 12] + _segment(marker, body) + cs[sot + 12:]
        psot = struct.unpack_from(">I", d, sot + 6)[0] + len(d) - len(cs)
        return d[:sot + 6] + struct.pack(">I", psot) + d[sot + 10:]

    return {
        "coc_qcc": main(sot, (0xFF53, coc), (0xFF5D, bytes([2]) + qcd)),
        "coc_before_cod": main(siz_end, (0xFF53, bytes([1, 0, 1]) + cod[6:])),
        "coc_16x16_blocks": main(sot, (0xFF53, bytes([1, 0, cod[5], 2, 2])
                                       + cod[8:])),
        "crg_com": main(sot, (0xFF63, bytes(12)), (0xFF64, b"\0\1hello")),
        "unknown_marker": main(sot, (0xFF6F, b"abcd")),
        "coc_in_tile": tile(0xFF53, coc), "com_in_tile": tile(0xFF64, b"\0\1x"),
        "plt_in_main": main(sot, (0xFF58, b"\0\x05")),
        "crg_too_short": main(sot, (0xFF63, bytes(8))),
        "tlm_in_tile": tile(0xFF55, b"\0\0")}


@pytest.mark.parametrize("irreversible", [False, True])
def test_header_markers_no_encoder_writes(irreversible):
    """COC / QCC / CRG / COM / unknown markers where OpenJPEG takes them,
    in j2k.c's order of precedence, and refusals of markers out of place
    or malformed, as PIL gives them."""
    decoded = {name: _same(d, ".j2k")
               for name, d in _header_cases(irreversible).items()}
    assert {n for n, ok in decoded.items() if not ok} == {
        "plt_in_main", "crg_too_short", "tlm_in_tile"}


# ------------------------------ JP2 boxes ------------------------------

def _box_cases(w, h, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 20, (h, w)).astype(np.int32)
    cs1 = _opj([idx], numres=2)
    ents = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(20)]
    ents[5] = ents[2]  # a repeated colour: getcolor merges it
    alpha = rng.integers(0, 256, (h, w)).astype(np.int32)
    cs2 = _opj([idx, alpha], numres=2)
    rgb = _planes(w, h, 3, seed=seed)
    rgba = _planes(w, h, 4, seed=seed)
    sub = [rgb[0], rgb[1][::2, ::2].copy(), rgb[2][::2, ::2].copy()]
    cs_sub = _opj(sub, sub=[(1, 1), (2, 2), (2, 2)], size=(w, h), mct=0,
                  numres=2)
    plain3, plain4 = _opj(rgb, mct=0, numres=2), _opj(rgba, mct=0, numres=2)
    return {
        "pclr": _jp2(cs1, 1, w, h, extra=[_pclr(ents, [7] * 3), _cmap(3)]),
        "pclr_no_cmap": _jp2(cs1, 1, w, h, extra=[_pclr(ents, [7] * 3)]),
        "pclr_rgba": _jp2(cs1, 1, w, h, extra=[
            _pclr([e + (200,) for e in ents], [7] * 4), _cmap(4)]),
        "pclr_16bit": _jp2(cs1, 1, w, h, extra=[
            _pclr([tuple(v * 257 for v in e) for e in ents], [15] * 3),
            _cmap(3)]),
        "pclr_grey_colr": _jp2(cs1, 1, w, h, colr=(1, 17),
                               extra=[_pclr(ents, [7] * 3), _cmap(3)]),
        "pa_cdef": _jp2(cs2, 2, w, h, extra=[
            _pclr(ents, [7] * 3), _cmap(3), _cdef([(0, 0, 1), (1, 1, 0)])]),
        "la_cdef": _jp2(cs2, 2, w, h, colr=(1, 17),
                        extra=[_cdef([(0, 0, 1), (1, 1, 0)])]),
        "res": _jp2(cs1, 1, w, h, colr=(1, 17), extra=[_res()]),
        "jpx": _jp2(cs1, 1, w, h, colr=(1, 17), brand=b"jpx "),
        "no_colr": _jp2(cs1, 1, w, h, colr=None),
        "icc": _jp2(plain3, 3, w, h, colr=(2, bytes(20))),
        "uuid_before_jp2h": _jp2(cs1, 1, w, h, colr=(1, 17),
                                 before=[_box(b"uuid", b"x" * 20)]),
        "ihdr_size_mismatch": _jp2(cs1, 1, w + 1, h, colr=(1, 17)),
        "bpcc": _jp2(cs1, 1, w, h, bpc=255, colr=(1, 17),
                     extra=[_box(b"bpcc", b"\x07")]),
        "sycc": _jp2(plain3, 3, w, h, colr=(1, 18)),
        "sycc_subsampled": _jp2(cs_sub, 3, w, h, colr=(1, 18)),
        "srgb_subsampled": _jp2(cs_sub, 3, w, h, colr=(1, 16)),
        "sycc_alpha": _jp2(plain4, 4, w, h, colr=(1, 18)),
        "cmyk": _jp2(plain4, 4, w, h, colr=(1, 12)),
        "eycc": _jp2(plain3, 3, w, h, colr=(1, 24)),
        "grey_colr_on_rgb": _jp2(_opj(rgb, numres=2), 3, w, h, colr=(1, 17)),
        "grey_colr_on_rgba": _jp2(plain4, 4, w, h, colr=(1, 17)),
        "ihdr_rgb_on_grey": _jp2(cs1, 3, w, h, colr=(1, 17)),
        "ihdr_rgba_on_grey_alpha": _jp2(cs2, 4, w, h, colr=(1, 17)),
        "unlisted_enumcs": _jp2(plain3, 3, w, h, colr=(1, 20))}


BOX_CASES = [
    "bpcc", "cmyk", "eycc", "grey_colr_on_rgb", "grey_colr_on_rgba", "icc",
    "ihdr_rgb_on_grey", "ihdr_rgba_on_grey_alpha", "ihdr_size_mismatch",
    "jpx", "la_cdef", "no_colr", "pa_cdef", "pclr", "pclr_16bit",
    "pclr_grey_colr", "pclr_no_cmap", "pclr_rgba", "res", "srgb_subsampled",
    "sycc", "sycc_alpha", "sycc_subsampled", "uuid_before_jp2h",
    "unlisted_enumcs"]
# what PIL does with each: an image, or a refusal (no unpacker for the
# mode and colour space: 16-bit entries leave mode L on an sRGB space, P on
# a grey one, grey on three components, eYCC; SIZ against ihdr)
BOX_REFUSED = {"eycc", "grey_colr_on_rgb", "ihdr_size_mismatch",
               "pclr_16bit", "pclr_grey_colr"}


@pytest.mark.parametrize("name", BOX_CASES)
def test_jp2_boxes(name):
    """JP2 boxes built around libopenjp2's codestreams: pclr as PIL reads
    it (P, PA, RGBA entries, repeated colours, 16-bit entries left as L),
    cmap, cdef (ignored by PIL's tile decode), colr sYCC, eYCC, CMYK,
    grey (also on four components, which PIL unpacks as RGBA), ICC and an
    unlisted EnumCS, res, a jpx brand, bpcc; ihdr's component count
    against SIZ's (PIL's mode from the one, the unpacker by the other)."""
    for (w, h), seed in (((7, 5), 1), ((33, 17), 2)):
        cases = _box_cases(w, h, seed)
        assert sorted(cases) == sorted(BOX_CASES)
        data = cases[name]
        assert _same(data) != (name in BOX_REFUSED), name


def test_icns_with_jpeg2000_elements():
    """ICNS elements that are JPEG 2000 (a J2K codestream or a JP2 file;
    PIL's read_png_or_jpeg2000 decodes the element's bytes alone), the
    largest size chosen, a small one whose size divides the slot's, and
    one that fits none of the file's sizes (both refuse it)."""
    rng = np.random.default_rng(8)
    for kw in ({}, {"no_jp2": True}, {"irreversible": True}):
        stream = _save(Image.fromarray(rng.integers(0, 256, (32, 32, 3)).astype(
            np.uint8)), "JPEG2000", **kw)
        for code in (b"ic12", b"ic11", b"icp5", b"ic07"):
            assert _same(_icns([(code, stream)]), ".icns")
        assert _same(_icns([(b"ic12", stream), (b"is32", bytes(768))]),
                     ".icns")
    small = _save(Image.fromarray(rng.integers(0, 256, (8, 8, 4)).astype(
        np.uint8)), "JPEG2000")
    assert _same(_icns([(b"ic07", small)]), ".icns")  # 128 / 8: it fits
    wide = _save(Image.fromarray(rng.integers(0, 256, (32, 48, 3)).astype(
        np.uint8)), "JPEG2000")
    assert not _same(_icns([(b"ic07", wide)]), ".icns")


# ------------------------ cut and corrupt streams ------------------------

def _flips(data: bytes, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = bytearray(data)
        p = int(rng.integers(2, len(data)))
        d[p] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(d))
    return out


def _damage_sources():
    a = _picture(33, 17, 3, 3)
    out = [_save(Image.fromarray(a), "JPEG2000", **kw) for kw in (
        {}, {"tile_size": (16, 16), "no_jp2": True},
        {"irreversible": True, "quality_mode": "rates",
         "quality_layers": [20, 5]},
        {"progression": "RPCL", "precincts": [(16, 16)], "no_jp2": True})]
    planes = list(np.moveaxis(a.astype(np.int32), -1, 0))
    out += [_opj(planes, numres=3, mode=1 | 4 | 32, sop=True, eph=True),
            _opj(planes, numres=3, mode=2 | 8, tp="R"),
            _opj(planes, numres=3, extra=["TLM=YES", "PLT=YES"],
                 tile=(16, 16))]
    return out


@pytest.mark.parametrize("source", range(7))
def test_cut_and_corrupt_streams(source):
    """Cut codestreams (anywhere, and with the last tile-part's Psot set to
    0, so that OpenJPEG reads to the end) and one-bit flips: PIL's image,
    which OpenJPEG often decodes in part, or both raise."""
    data = _damage_sources()[source]
    decoded = 0
    for d in _flips(data, 16, source):
        decoded += _same(d, ".j2k")
    for cut in sorted(set(np.linspace(10, len(data) - 1, 14).astype(int))):
        decoded += _same(data[:cut], ".j2k")
    sots = [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] == 0x90]
    d0 = bytearray(data)
    d0[sots[-1] + 6:sots[-1] + 10] = bytes(4)
    for cut in sorted(set(np.linspace(sots[-1] + 2, len(data),
                                      8).astype(int))):
        decoded += _same(bytes(d0[:cut]), ".j2k")
    assert decoded > 0


@pytest.mark.parametrize("source", range(2))
def test_main_header_byte_changes(source):
    """Bytes of the main header (SIZ, COD, QCD, COM) set to other values:
    PIL's image or both raise (sizes, precisions, subsampling, tile
    grids, levels, code-block sizes and styles, transforms, step sizes,
    guard bits, markers turned into others)."""
    data = (_opj(_planes(33, 17, 3, seed=1), numres=3),
            _opj(_planes(33, 17, 3, seed=2), numres=3, irreversible=True,
                 layers=[20, 4], tile=(16, 16)))[source]
    end = data.index(b"\xff\x90")
    rng = np.random.default_rng(source)
    # not the high bytes of Xsiz / Ysiz: images of gigabytes
    where = [p for p in range(2, end) if p not in (8, 9, 10, 12, 13, 14)]
    for pos in sorted(rng.choice(where, 24, replace=False)):
        for value in (0, 1, 0xFF, data[pos] ^ 1):
            if value != data[pos]:
                changed = bytearray(data)
                changed[pos] = value
                _same(bytes(changed), ".j2k")


def test_a_stream_cut_after_a_tile_part_marker_decodes_in_part():
    """A tiled codestream that stops right after its last tile-part's SOT
    marker code: PIL decodes every other tile and leaves that one black."""
    data = _save(Image.fromarray(_picture(33, 17, 3, 5)), "JPEG2000",
                 tile_size=(16, 16), no_jp2=True)
    last = data.rindex(b"\xff\x90")
    cut = data[:last + 2]
    got = tio.decode_image(cut, "case", ".j2k")
    np.testing.assert_array_equal(got, _pil(cut))
    full = _pil(data)
    assert (got[16:, 32:, :3] == 0).all() and not np.array_equal(got, full)
    np.testing.assert_array_equal(got[:16], full[:16])


# ------------------------------ the slice ------------------------------

def test_jpeg2000_texture_loads_match_jax(tmp_path):
    """render/scenebuild._load_texture_images on the ivy material's three
    maps as JP2 and J2K files: an image in every slot, equal to the JAX
    package's."""
    for suffix, kw in ((".jp2", {"irreversible": True}),
                       (".j2k", {"no_jp2": True, "tile_size": (32, 32)})):
        paths = {}
        for slot, name in (("albedo", "ivy_albedo"), ("normal", "ivy_normal"),
                           ("specular", "ivy_mr")):
            p = tmp_path / f"{name}{suffix}"
            Image.open(DEMO / f"{name}.png").resize((48, 48)).save(
                p, "JPEG2000", **kw)
            paths[slot] = str(p)
        paths = types.SimpleNamespace(**paths)
        got, want = tsb._load_texture_images(paths), \
            jsb._load_texture_images(paths)
        for slot in ("albedo", "normal", "specular"):
            g, w = getattr(got, slot), getattr(want, slot)
            assert g is not None and w is not None, slot
            np.testing.assert_array_equal(g, w, err_msg=slot)


def test_save_image_still_refuses_jpeg2000(tmp_path):
    """save_image writes JPEG 2000 from (H, W) and (H, W, 3|4) uint8
    (tests/test_torch_formats_j2k_write.py); under every JPEG 2000 suffix
    it still refuses the arrays it does not take (two channels, 16-bit),
    which PIL would write as LA or I;16, and writes nothing."""
    for suffix in (".jp2", ".j2k", ".jpc", ".jpf", ".jpx", ".j2c"):
        for a in (np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4), np.uint16)):
            with pytest.raises(ValueError, match="uint8"):
                tio.save_image(tmp_path / f"a{suffix}", a)
            assert not (tmp_path / f"a{suffix}").exists()


# ------------------------------ fixtures ------------------------------

# the courtyard's textures as JP2: PIL's irreversible save at 40:1, the
# options spread over them (tiles, RPCL with precincts, two layers)
COURTYARD_OPTIONS = {
    "stone": {"tile_size": (256, 256)},
    "wood": {"progression": "RPCL", "precincts": [(128, 128), (64, 64)]},
    "metal": {"quality_layers": [80, 40]},
    "ivy": {}}


def courtyard_files() -> dict:
    out = {}
    for png in sorted(DEMO.glob("*.png")):
        kw = {"irreversible": True, "quality_mode": "rates",
              "quality_layers": [40], **COURTYARD_OPTIONS[
                  png.stem.split("_")[0]]}
        out[png.stem + ".jp2"] = _save(Image.open(png), "JPEG2000", **kw)
    return out


def fixture_files() -> dict:
    """The committed fixtures: small files (at most 64 x 64) for the
    features chip_smoke.py checks on the card's machine."""
    w, h = 48, 40
    rgb = _planes(w, h, 3, seed=20)
    rng = np.random.default_rng(20)
    idx = rng.integers(0, 24, (h, w)).astype(np.int32)
    ents = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(24)]
    sub = [rgb[0], rgb[1][::2, ::2].copy(), rgb[2][::2, ::2].copy()]
    tiled = _save(Image.fromarray(_picture(w, h, 3, 21)), "JPEG2000",
                  tile_size=(32, 32), no_jp2=True)
    cut = tiled[:tiled.rindex(b"\xff\x90") + 2]
    return {
        "tiles_97.j2k": _save(Image.fromarray(_picture(w, h, 3, 22)),
                              "JPEG2000", irreversible=True, no_jp2=True,
                              tile_size=(32, 16), quality_mode="rates",
                              quality_layers=[12, 4]),
        "bypass_termall_segsym.jp2": _opj(rgb, mode=1 | 4 | 32, numres=4,
                                          jp2=True, cblk=(16, 16)),
        "rpcl_precincts_poc.j2k": _opj(
            rgb, numres=3, prog="RPCL", precincts=[(4, 4), (4, 4), (5, 5)],
            layers=[20, 4], pocs=POCS[2], irreversible=True),
        "grey16.jp2": _opj(_planes(w, h, 1, 16, seed=23), prec=16, numres=3,
                           jp2=True),
        "sycc_subsampled.jp2": _jp2(_opj(sub, sub=[(1, 1), (2, 2), (2, 2)],
                                         size=(w, h), mct=0, numres=3),
                                    3, w, h, colr=(1, 18)),
        "pclr.jp2": _jp2(_opj([idx], numres=2), 1, w, h,
                         extra=[_pclr(ents, [7] * 3), _cmap(3)]),
        "ppt_sop_eph.j2k": _move_headers(_opj(rgb, sop=True, eph=True,
                                              numres=3, layers=[20, 5]),
                                         "ppt"),
        "cut_in_part.j2k": cut,
        "rgn_vsc_reset.j2k": _opj(rgb, numres=3, roi=(0, 4), mode=2 | 8),
        "jp2_elements.icns": _icns([(b"ic07", _save(Image.fromarray(
            _picture(64, 64, 4, 24)), "JPEG2000"))]),
    }


def write_fixtures():
    COURTYARD.mkdir(parents=True, exist_ok=True)
    for old in list(FIXTURES.glob("*")) + list(COURTYARD.glob("*")):
        if old.is_file():
            old.unlink()
    for name, data in fixture_files().items():
        (FIXTURES / name).write_bytes(data)
        want = _pil(data)
        assert not isinstance(want, Exception), (name, want)
        Image.fromarray(want).save(FIXTURES / (name + ".png"))
    for name, data in courtyard_files().items():
        (COURTYARD / name).write_bytes(data)
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    print(f"{len(list(FIXTURES.rglob('*')))} files, {total} bytes")
    print("COURTYARD_JP2_SHA256 = " + repr(courtyard_digests()))


def courtyard_digests() -> dict:
    """SHA-256 of PIL's RGBA decode of each committed courtyard JP2."""
    return {p.stem: hashlib.sha256(np.ascontiguousarray(np.asarray(
        Image.open(p).convert("RGBA"))).tobytes()).hexdigest()
        for p in sorted(COURTYARD.glob("*.jp2"))}


def test_committed_fixtures_equal_pil_and_their_pngs():
    """Each committed file decodes in the port as in PIL and equals the
    PNG of PIL's decode beside it (what chip_smoke.py checks without
    PIL); the set is the one fixture_files makes; the new files stay
    under 300 KB."""
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if p.is_file() and not p.name.endswith(".png"))
    assert names == sorted(fixture_files())
    for name in names:
        data = (FIXTURES / name).read_bytes()
        got = tio.load_image(FIXTURES / name)
        assert got.shape[0] <= 64 and got.shape[1] <= 64
        np.testing.assert_array_equal(got, tio.load_image(
            FIXTURES / (name + ".png")), err_msg=name)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert total < 300_000


def test_courtyard_jp2_digests_are_pils():
    """The 12 committed courtyard textures as JP2: PIL's decodes have the
    digests chip_smoke.COURTYARD_JP2_SHA256 holds the port to on the card's
    machine, and the files are the ones courtyard_files writes; the port
    decodes the 256 x 256 ones to those digests here (the 512 x 512 ones
    only on the card's machine, for time)."""
    import chip_smoke

    assert courtyard_digests() == chip_smoke.COURTYARD_JP2_SHA256
    assert sorted(p.name for p in COURTYARD.iterdir()) == sorted(
        courtyard_files())
    for p in sorted(COURTYARD.glob("*.jp2")):
        if p.stem.startswith("stone"):
            continue
        digest = hashlib.sha256(tio.load_image(p).tobytes()).hexdigest()
        assert digest == chip_smoke.COURTYARD_JP2_SHA256[p.stem], p.name


def print_decode_times():
    """Each committed fixture's host decode time (best of 3), in ms."""
    import time
    for path in sorted(FIXTURES.rglob("*")):
        if not path.is_file() or path.name.endswith(".png"):
            continue
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            tio.load_image(path)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{path.relative_to(FIXTURES)}: {min(times):.2f} ms")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
    else:
        print_decode_times()
