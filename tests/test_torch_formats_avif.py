"""AVIF in the port (assets/avif.py over isobmff.py, the AV1 intra decoder
av1_decode.py with av1_obu.py, av1_msac.py, av1_cdf.py, av1_block.py,
av1_intra.py, av1_intrabc.py, av1_transform.py, av1_loopfilter.py,
av1_cdef.py, av1_restoration.py and av1_filmgrain.py, and avif_yuv.py)
against PIL 12.1's AVIF plugin (libavif 1.3.0 with dav1d 1.5.1), which the
JAX package's load_image uses:

  - files PIL writes from seeded numpy images, at 1x1, odd sizes and sizes
    off the 8 / 64 grid: quality 0 / 30 / 75 / 100 and lossless, speed
    0 / 6 / 10, subsampling 4:2:0 / 4:2:2 / 4:4:4 / 4:0:0, full and
    limited range, RGB, straight and premultiplied RGBA, tile rows,
    columns and autotiling, each ``advanced`` option that changes the
    bytes (CDEF, quantizer matrices, lossless, screen content, film
    grain, chroma delta q, sharpness, CfL / filter intra / smooth intra
    off), an EXIF orientation (irot, not applied) and an ICC profile, and
    frame 0 of a 3-frame sequence: ``load_image`` equals the JAX
    package's bit for bit;
  - the coding tools those files reach, read from the decoder's record of
    each frame (palette, filter intra, intra edge filter, CfL, intra block
    copy, lossless WHT, quantizer matrices, deblocking, CDEF, loop
    restoration, film grain, 128x128 superblocks, tiles, monochrome);
  - containers built here around PIL's AV1 payloads: an image grid, an
    item in ``idat``, ``clap``, an alpha item of another aux type, and the
    files libavif refuses;
  - files cut at box, OBU and tile boundaries and a seeded sweep of bit
    flips: the same image as PIL's, or both raise;
  - the committed fixtures in tests/data/formats_avif, each beside PIL's
    decode of it as PNG, and the courtyard's 12 textures as PIL's default
    AVIF saves (tests/data/formats_avif/courtyard) against the digests of
    PIL's decodes that chip_smoke.py holds the port to on the card's
    machine, which has no PIL;
  - render/scenebuild._load_texture_images on the courtyard's AVIF maps
    against the JAX package's.

``PYTHONPATH=. python tests/test_torch_formats_avif.py --write-fixtures``
regenerates tests/data/formats_avif; ``--sweep N SEED`` runs N seeded bit
flips in each of 11 PIL saves against PIL and prints what differs; with
no flag it prints each fixture's decode time on the host. One thread, no
card."""

import hashlib
import io
import struct
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageCms

from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu_torch.assets import (av1_decode, av1_obu, avif_write,
                                            isobmff)
from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.render import scenebuild as tsb
import torch_avif_depth
from test_torch_formats import _picture, _pil, _save

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
FIXTURES = Path(__file__).resolve().parent / "data" / "formats_avif"
COURTYARD = FIXTURES / "courtyard"


def _rgba(w, h, seed):
    return _picture(w, h, 4, seed)


def _image(w, h, mode, seed):
    if mode == "RGBA":
        return Image.fromarray(_rgba(w, h, seed))
    if mode == "L":
        return Image.fromarray(_picture(w, h, 1, seed)[..., 0])
    return Image.fromarray(_picture(w, h, 3, seed))


def _jax(tmp_path, data: bytes, name="case.avif"):
    p = tmp_path / name
    p.write_bytes(data)
    try:
        return jio.load_image(p)
    except Exception as e:  # noqa: BLE001 - any refusal of PIL's
        return e


def _same(tmp_path, data: bytes, name="case.avif"):
    """The port's load_image is the JAX package's: the same array, or both
    raise (the port with ValueError). Returns the image or None."""
    want = _jax(tmp_path, data, name)
    p = tmp_path / name
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            tio.load_image(p)
        return None
    got = tio.load_image(p)
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape,
                                                              want.shape)
    np.testing.assert_array_equal(got, want)
    return got


def _payload(data: bytes, which="color") -> bytes:
    """The AV1 sample of the primary item (or of its alpha item)."""
    f = isobmff.parse(data)
    item = f.items[f.primary]
    if which == "alpha":
        item = next(i for i in f.items.values()
                    if f.primary in i.refs.get(b"auxl", []))
    return isobmff.item_payload(data, f, item)


# ------------------------- PIL's saves -------------------------------

EXIF6 = Image.Exif()
EXIF6[0x0112] = 6     # PIL writes irot
EXIF2 = Image.Exif()
EXIF2[0x0112] = 2     # PIL writes imir
ICC = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
# name -> (width, height, mode, save options, the tools its colour frame
# reaches)
CASES = {
    "q75_1x1": (1, 1, "RGB", {}, set()),
    "q75_7x5": (7, 5, "RGB", {}, {"cfl"}),
    "q75_65x33": (65, 33, "RGB", {}, {"deblock"}),
    "q0": (40, 24, "RGB", {"quality": 0}, {"deblock"}),
    "q30": (40, 24, "RGB", {"quality": 30}, {"deblock"}),
    "q100": (33, 17, "RGB", {"quality": 100}, set()),
    "lossless": (33, 17, "RGB", {"advanced": {"lossless": "1"}}, {"wht"}),
    "speed0": (48, 40, "RGB", {"speed": 0},
               {"lr", "sb128", "filter_intra", "intra_edge"}),
    "speed10": (48, 40, "RGB", {"speed": 10}, set()),
    "s422": (37, 29, "RGB", {"subsampling": "4:2:2"}, set()),
    "s444": (37, 29, "RGB", {"subsampling": "4:4:4"}, set()),
    "s400": (37, 29, "RGB", {"subsampling": "4:0:0"}, {"mono"}),
    "grey": (30, 20, "L", {}, set()),
    "limited": (37, 29, "RGB", {"range": "limited"}, set()),
    "rgba": (31, 23, "RGBA", {}, set()),
    "rgba_prem": (31, 23, "RGBA", {"alpha_premultiplied": True}, set()),
    "tiles": (130, 40, "RGB", {"tile_rows": 1, "tile_cols": 1}, {"tiles"}),
    "autotile": (70, 40, "RGB", {"autotiling": True}, set()),
    "cdef": (48, 40, "RGB", {"quality": 40,
                             "advanced": {"enable-cdef": "1"}}, {"cdef"}),
    "cdef_lr": (72, 40, "RGB", {"speed": 0, "quality": 30,
                                "advanced": {"enable-cdef": "1"}},
                {"cdef", "deblock", "filter_intra"}),
    "qm": (48, 40, "RGB", {"quality": 50,
                           "advanced": {"enable-qm": "1", "qm-min": "0",
                                        "qm-max": "8"}}, {"qm"}),
    "screen": (64, 48, "RGB", {"advanced": {"tune-content": "screen"}},
               {"palette"}),
    "screen_intrabc": (260, 150, "shapes",
                       {"advanced": {"tune-content": "screen"}},
                       {"intrabc", "palette"}),
    "grain": (40, 24, "RGB", {"advanced": {"film-grain-test": "1"}},
              {"grain"}),
    "grain444": (40, 24, "RGB", {"subsampling": "4:4:4",
                                 "advanced": {"film-grain-test": "10"}},
                 {"grain"}),
    "chroma_deltaq": (40, 24, "RGB",
                      {"advanced": {"enable-chroma-deltaq": "1"}}, set()),
    "sharpness": (40, 24, "RGB", {"advanced": {"sharpness": "3"}}, set()),
    "no_cfl": (40, 24, "RGB", {"advanced": {"enable-cfl-intra": "0"}},
               set()),
    "no_filter_intra": (48, 40, "RGB", {
        "speed": 0, "advanced": {"enable-filter-intra": "0"}}, set()),
    "no_smooth_intra": (40, 24, "RGB", {
        "advanced": {"enable-smooth-intra": "0"}}, set()),
    "exif_orientation": (30, 20, "RGB", {"exif": EXIF6.tobytes()}, set()),
    "exif_mirror": (30, 20, "RGB", {"exif": EXIF2.tobytes()}, set()),
    "icc": (30, 20, "RGB", {"icc_profile": ICC}, set()),
}


def _screen_picture(w, h, seed):
    """A few flat colours in rectangles: palette and block copy content."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    cols = rng.integers(0, 256, (5, 3))
    for _ in range(30):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(2, 12), x:x + rng.integers(2, 16)] = \
            cols[rng.integers(0, 5)]
    return Image.fromarray(img)


def _shapes(w, h, seed):
    """Gradients under a few flat discs: screen content that libaom codes
    with intra block copy at this size."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                    (x * y // 7) % 256], -1)
    for _ in range(6):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        rad = rng.integers(2, min(h, w) // 2)
        img[(y - cy) ** 2 + (x - cx) ** 2 < rad ** 2] = rng.integers(0, 256, 3)
    return Image.fromarray(img.astype(np.uint8))


def _case_file(name) -> bytes:
    w, h, mode, kw, _ = CASES[name]
    seed = sum(map(ord, name))
    if name == "screen":
        im = _screen_picture(w, h, seed)
    elif mode == "shapes":
        im = _shapes(w, h, 2)
    else:
        im = _image(w, h, mode, seed)
    return _save(im, "AVIF", **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pil_saves_match_jax(tmp_path, name):
    """Each setting: the JAX package's load_image, bit for bit, and the
    tools it means to reach set in the colour frame."""
    data = _case_file(name)
    assert _same(tmp_path, data) is not None
    # every tile of PIL's stream ends on its padding: the parse kept step
    tools = av1_decode.decode(_payload(data), check_trailing=True).tools
    assert CASES[name][4] <= tools, (name, sorted(tools))
    if name.startswith("no_"):   # the tool switched off stays off
        off = {"no_cfl": "cfl", "no_filter_intra": "filter_intra"}.get(name)
        assert off not in tools, (name, sorted(tools))
    if name.startswith("exif"):  # the transform box is there, not applied
        assert (b"irot" if name.endswith("orientation") else b"imir") in data


def test_sequence_first_frame_matches_jax(tmp_path):
    """Frame 0 of a 3-frame RGBA sequence (an 'avis' file with tracks)."""
    frames = [Image.fromarray(_rgba(26, 18, 60 + k)) for k in range(3)]
    data = _save(frames[0], "AVIF", save_all=True, append_images=frames[1:])
    assert data[8:12] == b"avis"
    assert _same(tmp_path, data) is not None


def test_courtyard_alpha_uses_intrabc():
    """The courtyard's albedo alpha (few levels), which libaom codes with
    intra block copy and palette: the tools set in the committed ivy map's
    alpha frame (the map itself is held to the JAX package in
    test_texture_images_match_jax)."""
    data = (COURTYARD / "ivy_albedo.avif").read_bytes()
    tools = av1_decode.decode(_payload(data, "alpha")).tools
    assert {"intrabc", "mono", "palette"} <= tools, sorted(tools)


def test_tool_coverage():
    """Every tool the port decodes is reached by at least one case above
    (the union over the cases' colour frames and the intrabc alpha)."""
    want = {"palette", "filter_intra", "intra_edge", "cfl", "wht", "qm",
            "intrabc",
            "deblock", "cdef", "lr", "grain", "sb128", "tiles", "mono"}
    union = set().union(*(c[4] for c in CASES.values()))
    assert want <= union


def _bits(data: bytes) -> str:
    return "".join(format(b, "08b") for b in data)


def _obu(typ: int, payload: bytes) -> bytes:
    size, out = len(payload), b""
    while True:
        byte = size & 0x7F
        size >>= 7
        out += bytes([byte | (0x80 if size else 0)])
        if not size:
            break
    return bytes([(typ << 3) | 2]) + out + payload


def test_refused_tools_are_named(tmp_path):
    """A sample holding a second frame (spatial layers) raises ValueError
    naming it. A superres frame (PIL refuses the encoder's superres
    options), built by setting the bits in PIL's 8-bit stream, is kept at
    its 7 samples by the floor of 16 and decodes as the plain stream and
    as PIL; the same stream with high_bitdepth set is a 10-bit one, which
    the port decodes as PIL does."""
    pl = _payload(_case_file("q75_7x5"))
    obus = {t: (s, e) for t, _, _, s, e in av1_obu.obus(pl)}
    s0, e0 = obus[av1_obu.OBU_SEQUENCE_HEADER]
    seq = av1_obu.sequence_header(pl, s0, e0)
    assert seq.reduced and seq.bit_depth == 8
    # reduced header: 18 bits, the two sizes, then use_128 .. restoration
    at = 18 + seq.frame_width_bits + seq.frame_height_bits + 6
    sbits = _bits(pl[s0:e0])
    fs_, fe = obus[av1_obu.OBU_FRAME]
    fbits = _bits(pl[fs_:fe])

    def stream(sb, fb):
        def pack(b):
            b += "0" * (-len(b) % 8)
            return bytes(int(b[i:i + 8], 2) for i in range(0, len(b), 8))
        return (_obu(av1_obu.OBU_SEQUENCE_HEADER, pack(sb))
                + _obu(av1_obu.OBU_FRAME, pack(fb)))

    high = sbits[:at] + "1" + sbits[at + 1:]
    ten = torch_avif_depth.to_depth(_case_file("q75_7x5"), 10)
    frame = av1_decode.decode(stream(high, fbits))
    assert frame.seq.bit_depth == 10
    for got, want in zip(frame.planes, av1_decode.decode(_payload(ten)).planes):
        np.testing.assert_array_equal(got, want)
    _same(tmp_path, ten)
    # enable_superres on, and the frame's use_superres = 1, coded_denom 0
    # after disable_cdf_update and allow_screen_content_tools, the header
    # padded to its byte again before the tile data
    ends = []

    class Reader(av1_obu.BitReader):
        def byte_align(self):
            ends.append(self.bit - 8 * fs_)
            super().byte_align()

    plain, av1_obu.BitReader = av1_obu.BitReader, Reader
    try:
        av1_obu.frame_header(pl, fs_, fe, seq)
    finally:
        av1_obu.BitReader = plain
    sup = sbits[:at - 3] + "1" + sbits[at - 2:]
    head = fbits[:2] + "1000" + fbits[2:ends[0]]
    frame = head + "0" * (-len(head) % 8) + fbits[-(-ends[0] // 8) * 8:]
    assert not av1_obu.frame_header(pl, fs_, fe, seq)[0].allow_screen_content_tools
    got = av1_decode.decode(stream(sup, frame))
    assert got.hdr.use_superres and got.width == got.hdr.width == 7
    for a, b in zip(got.planes, av1_decode.decode(pl).planes):
        np.testing.assert_array_equal(a, b)
    _same(tmp_path, avif_write.write(7, 5, stream(sup, frame), got.seq))
    with pytest.raises(ValueError, match="spatial layers"):
        av1_decode.decode(pl + _obu(av1_obu.OBU_FRAME, pl[fs_:fe]))


# ---------------------- containers built here ------------------------

def _box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + typ + body


def _full(typ, version, flags, body):
    return _box(typ, bytes([version]) + flags.to_bytes(3, "big") + body)


def _props(data: bytes) -> dict:
    """The primary item's property boxes as bytes, by type."""
    out = {}
    pos = 0
    for typ, s, e in isobmff.boxes(data, 0, len(data), top=True):
        if typ != b"meta":
            continue
        for t2, s2, e2 in isobmff.boxes(data, s + 4, e):
            if t2 != b"iprp":
                continue
            for t3, s3, e3 in isobmff.boxes(data, s2, e2):
                if t3 == b"ipco":
                    for t4, s4, e4 in isobmff.boxes(data, s3, e3):
                        out.setdefault(t4, data[s4 - 8:e4])
    del pos
    return out


def _build(items, primary, brands=(b"avif", b"mif1", b"miaf"),
           refs=(), idat_items=(), major=b"avif", hdlr=b"pict"):
    """An AVIF file: items = [(id, type, payload, [property boxes],
    [essential flags])], refs = [(type, from, [to])]; payloads in idat for
    the ids in idat_items, else in mdat."""
    ftyp = _box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands))
    items = sorted(items)    # libavif wants ascending item ids in ipma
    props, assoc = [], []
    for iid, _, _, pboxes, ess in items:
        idx = []
        for pb, e in zip(pboxes, ess):
            props.append(pb)
            idx.append((len(props), e))
        assoc.append((iid, idx))
    ipco = _box(b"ipco", b"".join(props))
    ipma = _full(b"ipma", 0, 0, struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", iid, len(ix)) + bytes(
            (e << 7) | i for i, e in ix) for iid, ix in assoc))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", len(items)) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", iid, 0) + typ + b"\0")
        for iid, typ, _, _, _ in items))
    iref = b""
    if refs:
        iref = _full(b"iref", 0, 0, b"".join(_box(t, struct.pack(
            ">HH", a, len(b)) + b"".join(struct.pack(">H", x) for x in b))
            for t, a, b in refs))
    idat = b"".join(p for iid, _, p, _, _ in items if iid in idat_items)

    def meta_with(base):
        ents = []
        mdat_off = base
        idat_off = 0
        for iid, _, p, _, _ in items:
            if iid in idat_items:
                ents.append(struct.pack(">HHHHII", iid, 1, 0, 1, idat_off,
                                        len(p)))
                idat_off += len(p)
            else:
                ents.append(struct.pack(">HHHHII", iid, 0, 0, 1, mdat_off,
                                        len(p)))
                mdat_off += len(p)
        iloc = _full(b"iloc", 1, 0, bytes([0x44, 0x00]) + struct.pack(
            ">H", len(items)) + b"".join(ents))
        body = (_full(b"hdlr", 0, 0, b"\0" * 4 + hdlr + b"\0" * 13)
                + _full(b"pitm", 0, 0, struct.pack(">H", primary)) + iloc
                + iinf + iref + _box(b"iprp", ipco + ipma)
                + (_box(b"idat", idat) if idat_items else b""))
        return _full(b"meta", 0, 0, body)

    head = ftyp + meta_with(0)
    meta = meta_with(len(head) + 8)
    mdat = _box(b"mdat", b"".join(p for iid, _, p, _, _ in items
                                  if iid not in idat_items))
    return ftyp + meta + mdat


def _parts(im, **kw):
    """PIL's AVIF save of im: its primary payload and property boxes."""
    data = _save(im, "AVIF", **kw)
    return _payload(data), _props(data), data


def _ispe(w, h):
    return _full(b"ispe", 0, 0, struct.pack(">II", w, h))


def _std(props, w=None, h=None):
    ispe = props[b"ispe"] if w is None else _ispe(w, h)
    return [ispe, props[b"pixi"], props[b"av1C"], props[b"colr"]], [
        0, 0, 1, 0]


def test_built_single_item_and_idat_match_jax(tmp_path):
    """The PIL payload rebuilt as a plain item, and moved into idat."""
    pl, props, _ = _parts(_image(24, 16, "RGB", 70))
    boxes, ess = _std(props)
    for idat in ((), (1,)):
        data = _build([(1, b"av01", pl, boxes, ess)], 1, idat_items=idat)
        assert _same(tmp_path, data) is not None


def _grid_file(big, rows, cols, out_w, out_h, tile=64):
    """A grid item over rows x cols tiles of big (PIL's saves of each)."""
    tiles, props = [], None
    for r in range(rows):
        for c in range(cols):
            pl, props, _ = _parts(Image.fromarray(
                big[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile].copy()))
            tiles.append(pl)
    boxes, ess = _std(props)
    items = [(10 + k, b"av01", pl, boxes, ess) for k, pl in enumerate(tiles)]
    grid = bytes([0, 0, rows - 1, cols - 1]) + struct.pack(">HH", out_w,
                                                           out_h)
    items.append((1, b"grid", grid, [_ispe(out_w, out_h), props[b"colr"]],
                  [0, 0]))
    return _build(items, 1, refs=[(b"dimg", 1, [10 + k for k in range(
        len(tiles))])])


def test_built_grid_matches_jax(tmp_path):
    """A 2 x 2 grid of 64 x 64 tiles cropped to 120 x 100, and a 1 x 2 grid
    whose output fills its tiles: libavif's assembly, then one YUV to RGB
    over the whole image; tiles under 64 x 64 are refused by both."""
    big = _picture(128, 128, 3, 71)
    for rows, cols, (ow, oh) in ((2, 2, (120, 100)), (1, 2, (128, 64))):
        got = _same(tmp_path, _grid_file(big, rows, cols, ow, oh))
        assert got is not None and got.shape == (oh, ow, 4)
    assert _same(tmp_path, _grid_file(big, 2, 2, 60, 44, tile=32)) is None


def test_built_clap_and_aux_types_match_jax(tmp_path):
    """A clap property (not applied), an alpha item whose auxC is not the
    alpha URN (ignored), and one that is (applied)."""
    pl, props, _ = _parts(_image(24, 16, "RGB", 72))
    apl, aprops, _ = _parts(Image.fromarray(_picture(24, 16, 1, 73)[..., 0]))
    clap = _box(b"clap", struct.pack(">8I", 20, 1, 12, 1, 0, 1, 0, 1))
    boxes, ess = _std(props)
    data = _build([(1, b"av01", pl, boxes + [clap], ess + [1])], 1)
    assert _same(tmp_path, data) is not None
    for urn in (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
                b"urn:example:depth"):
        aux = _full(b"auxC", 0, 0, urn + b"\0")
        items = [(1, b"av01", pl, boxes, ess),
                 (2, b"av01", apl, [aprops[b"ispe"], aprops[b"av1C"], aux],
                  [0, 1, 0])]
        data = _build(items, 1, refs=[(b"auxl", 2, [1])])
        got = _same(tmp_path, data)
        assert got is not None


@pytest.mark.parametrize("fault", [
    "no_ispe", "no_av1c", "pitm_missing", "primary_mime", "grid_count",
    "extent_past_eof", "brand_mif1_only", "not_pict"])
def test_built_refusals_match_jax(tmp_path, fault):
    """Files libavif refuses: the port raises too."""
    pl, props, _ = _parts(_image(24, 16, "RGB", 74))
    boxes, ess = _std(props)
    items = [(1, b"av01", pl, boxes, ess)]
    kw = {}
    primary = 1
    if fault == "no_ispe":
        items = [(1, b"av01", pl, boxes[1:], ess[1:])]
    elif fault == "no_av1c":
        items = [(1, b"av01", pl, boxes[:2] + boxes[3:], ess[:2] + ess[3:])]
    elif fault == "pitm_missing":
        primary = 5
    elif fault == "primary_mime":
        items = [(1, b"mime", pl, boxes, ess)]
    elif fault == "grid_count":
        items.append((2, b"grid", bytes([0, 0, 1, 1]) + struct.pack(
            ">HH", 24, 16), [_ispe(24, 16)], [0]))
        kw["refs"] = [(b"dimg", 2, [1])]
        primary = 2
    elif fault == "brand_mif1_only":
        kw["brands"] = (b"mif1", b"miaf")
        kw["major"] = b"mif1"
    elif fault == "not_pict":
        kw["hdlr"] = b"vide"
    data = _build(items, primary, **kw)
    if fault == "extent_past_eof":
        data = data[:-10]
    assert _same(tmp_path, data) is None


# ------------------------- cut and corrupt ---------------------------

def _cut_points(data: bytes) -> list:
    """Box boundaries, the OBU boundaries of the colour payload and points
    inside its tile data."""
    pts = set()
    for _, s, e in isobmff.boxes(data, 0, len(data), top=True):
        pts.update((s - 8, s, e - 1))
    f = isobmff.parse(data)
    off = f.items[f.primary].extents[0][0]
    pl = _payload(data)
    for _, _, _, s, e in av1_obu.obus(pl):
        pts.update((off + s - 2, off + s, off + (s + e) // 2, off + e - 1))
    return sorted(p for p in pts if 0 < p < len(data))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_cut_files_match_jax(tmp_path, mode):
    """Files cut at box, OBU and tile-data boundaries: PIL's image (dav1d
    decodes a cut tile as if zero bits followed) or both raise."""
    data = _save(_image(24, 16, mode, 75), "AVIF")
    for k, cut in enumerate(_cut_points(data)):
        _same(tmp_path, data[:cut], f"cut{k}.avif")


@pytest.mark.parametrize("seed", range(4))
def test_bit_flips_match_jax(tmp_path, seed):
    """A seeded sweep of single bit flips over the whole file."""
    data = _save(_image(24, 16, "RGB", 76 + seed), "AVIF")
    rng = np.random.default_rng(seed)
    for k in range(12):
        buf = bytearray(data)
        bit = int(rng.integers(0, len(data) * 8))
        buf[bit >> 3] ^= 0x80 >> (bit & 7)
        _same(tmp_path, bytes(buf), f"flip{k}.avif")


def test_save_image_still_refuses_avif(tmp_path):
    """AVIF is written now (tests/test_torch_formats_avif_write.py): .avif
    and .avifs give the same file, which PIL and the port read back alike;
    only what PIL refuses (a picture of zero size) is still refused."""
    a = np.zeros((4, 4, 3), np.uint8)
    a[1:3, 1:3] = (200, 40, 90)
    for suffix in (".avif", ".avifs"):
        tio.save_image(tmp_path / f"a{suffix}", a)
        assert _same(tmp_path, (tmp_path / f"a{suffix}").read_bytes(),
                     f"b{suffix}") is not None
    assert (tmp_path / "a.avif").read_bytes() == \
        (tmp_path / "a.avifs").read_bytes()
    with pytest.raises(ValueError, match="AVIF"):
        tio.save_image(tmp_path / "z.avif", np.zeros((0, 4, 3), np.uint8))
    assert not (tmp_path / "z.avif").exists()


# ------------------------------ fixtures ------------------------------

def courtyard_files() -> dict:
    """The courtyard's 12 textures as PIL's default AVIF saves."""
    return {png.stem + ".avif": _save(Image.open(png), "AVIF")
            for png in sorted(DEMO.glob("*.png"))}


def fixture_files() -> dict:
    """The committed fixtures: small files (at most 64 x 64) for the
    tools chip_smoke.py checks on the card's machine."""
    frames = [Image.fromarray(_rgba(24, 16, 80 + k)) for k in range(3)]
    pl, props, _ = _parts(_image(24, 16, "RGB", 81))
    boxes, ess = _std(props)
    grid = _grid_file(_picture(128, 64, 3, 82), 1, 2, 124, 64)
    return {
        "default_rgb.avif": _case_file("q75_65x33"),
        "rgba_premultiplied.avif": _save(Image.fromarray(_rgba(33, 21, 83)),
                                         "AVIF", alpha_premultiplied=True),
        "screen_intrabc.avif": _case_file("screen_intrabc"),
        "limited_422.avif": _save(_image(37, 29, "RGB", 84), "AVIF",
                                  range="limited", subsampling="4:2:2"),
        "lossless_444.avif": _save(_image(33, 17, "RGB", 85), "AVIF",
                                   subsampling="4:4:4",
                                   advanced={"lossless": "1"}),
        "cdef_lr_speed0.avif": _case_file("cdef_lr"),
        "qm.avif": _case_file("qm"),
        "grain.avif": _case_file("grain"),
        "screen_palette.avif": _case_file("screen"),
        "mono_400.avif": _case_file("s400"),
        "tiles.avif": _save(_image(64 + 66, 24, "RGB", 86), "AVIF",
                            tile_cols=1),
        "grid.avif": grid,
        "idat.avif": _build([(1, b"av01", pl, boxes, ess)], 1,
                            idat_items=(1,)),
        "sequence_rgba.avif": _save(frames[0], "AVIF", save_all=True,
                                    append_images=frames[1:]),
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
    print("COURTYARD_AVIF_SHA256 = " + repr(courtyard_digests()))


def courtyard_digests() -> dict:
    """SHA-256 of PIL's RGBA decode of each committed courtyard AVIF."""
    return {p.stem: hashlib.sha256(np.ascontiguousarray(np.asarray(
        Image.open(p).convert("RGBA"))).tobytes()).hexdigest()
        for p in sorted(COURTYARD.glob("*.avif"))}


def test_committed_fixtures_equal_pil_and_their_pngs():
    """Each committed file decodes in the port as in PIL and equals the
    PNG of PIL's decode beside it (what chip_smoke.py checks without
    PIL); the set is the one fixture_files makes; the folder stays under
    300 KB."""
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if p.is_file() and not p.name.endswith(".png"))
    assert names == sorted(fixture_files())
    for name in names:
        data = (FIXTURES / name).read_bytes()
        got = tio.load_image(FIXTURES / name)
        assert got.shape[0] <= 150 and got.shape[1] <= 260
        np.testing.assert_array_equal(got, tio.load_image(
            FIXTURES / (name + ".png")), err_msg=name)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert total < 300_000


def test_courtyard_avif_digests_are_pils():
    """The 12 committed courtyard textures as AVIF: PIL's decodes have the
    digests chip_smoke.COURTYARD_AVIF_SHA256 holds the port to on the
    card's machine, and the files are the ones courtyard_files writes; the
    port decodes the small maps to those digests here (the rest only on
    the card's machine, and in test_texture_images_match_jax, for time)."""
    import chip_smoke

    assert courtyard_digests() == chip_smoke.COURTYARD_AVIF_SHA256
    assert sorted(p.name for p in COURTYARD.iterdir()) == sorted(
        courtyard_files())
    for p in sorted(COURTYARD.glob("*_mr.avif")):
        if p.stem.startswith("stone"):
            continue
        digest = hashlib.sha256(tio.load_image(p).tobytes()).hexdigest()
        assert digest == chip_smoke.COURTYARD_AVIF_SHA256[p.stem], p.name


@pytest.mark.parametrize("material", ["ivy", "metal", "wood"])
def test_texture_images_match_jax(material):
    """render/scenebuild._load_texture_images on the courtyard's committed
    AVIF maps of one material (256 x 256; stone's 512 x 512 maps are held
    by chip_smoke.py's digests): an image in every slot, equal to the JAX
    package's."""
    paths = types.SimpleNamespace(
        albedo=str(COURTYARD / f"{material}_albedo.avif"),
        normal=str(COURTYARD / f"{material}_normal.avif"),
        specular=str(COURTYARD / f"{material}_mr.avif"))
    got, want = tsb._load_texture_images(paths), \
        jsb._load_texture_images(paths)
    for slot in ("albedo", "normal", "specular"):
        g, w = getattr(got, slot), getattr(want, slot)
        assert g is not None and w is not None, slot
        np.testing.assert_array_equal(g, w, err_msg=slot)


def sweep_flips(n: int, seed: int) -> dict:
    """n seeded single-bit flips in each of 11 PIL saves (CASES' cdef_lr,
    s422, s444, rgba_prem, screen, qm, grain444, lossless, tiles, q0 and
    a 3-frame sequence): how many decode equal to PIL's, raise in both,
    or differ (listed)."""
    names = ("cdef_lr", "s422", "s444", "rgba_prem", "screen", "qm",
             "grain444", "lossless", "tiles", "q0")
    files = [_case_file(n) for n in names]
    frames = [Image.fromarray(_rgba(26, 18, 60 + k)) for k in range(3)]
    files.append(_save(frames[0], "AVIF", save_all=True,
                       append_images=frames[1:]))
    out = {"equal": 0, "both raise": 0, "differ": []}
    for fi, data in enumerate(files):
        rng = np.random.default_rng(fi + seed)
        for _ in range(n):
            buf = bytearray(data)
            bit = int(rng.integers(0, len(data) * 8))
            buf[bit >> 3] ^= 0x80 >> (bit & 7)
            want = _pil(bytes(buf))
            try:
                got = tio.decode_image(bytes(buf), "flip", ".avif")
            except ValueError as e:
                got = e
            if isinstance(want, Exception) and isinstance(got, Exception):
                out["both raise"] += 1
            elif (not isinstance(want, Exception)
                  and not isinstance(got, Exception)
                  and np.array_equal(want, got)):
                out["equal"] += 1
            else:
                out["differ"].append((fi, bit >> 3, repr(want)[:60],
                                      repr(got)[:60]))
    return out


def print_decode_times():
    """Each committed fixture's host decode time (best of 3), in ms."""
    import time
    for path in sorted(FIXTURES.rglob("*.avif")):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            tio.load_image(path)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{path.relative_to(FIXTURES)}: {min(times):.2f} ms")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
    elif "--sweep" in sys.argv:   # --sweep N SEED
        i = sys.argv.index("--sweep")
        res = sweep_flips(int(sys.argv[i + 1]), int(sys.argv[i + 2]))
        print(f"equal {res['equal']}, both raise {res['both raise']}, "
              f"differ {len(res['differ'])}")
        for d in res["differ"]:
            print(d)
    else:
        print_decode_times()
