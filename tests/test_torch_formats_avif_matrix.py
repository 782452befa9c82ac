"""AVIF colour conversion and item scaling in the port (assets/avif_yuv.py,
assets/avif_reformat.py, assets/avif_scale.py, assets/avif.py) against
PIL 12.1's AVIF plugin (libavif 1.3.0 with dav1d 1.5.1), which the JAX
package's load_image uses, and against the same libavif's functions
through ctypes (tests/torch_libavif.py):

  - every matrix coefficients value 0-255 in the nclx property of a 4:4:4
    full-range PIL save, and matrix 12 over the colour primaries 0-255:
    load_image equals the JAX package's bit for bit, or both raise;
  - each matrix libavif converts x 4:2:0 / 4:2:2 / 4:0:0 x full / limited
    range x RGB / RGBA / premultiplied RGBA, on odd-sized PIL saves whose
    nclx matrix is rewritten;
  - files libavif itself writes through ctypes: the lossless identity
    (matrix 0, 4:4:4) and YCgCo (matrix 8) at 4:2:0 / 4:2:2 / 4:4:4;
  - the conversion on sampled (Y, U, V) triples and random subsampled
    planes with alpha against avifImageYUVToRGB, per path and range;
  - items whose ispe differs from their AV1 frame (colour, alpha, grid
    tiles) and sequences whose tkhd size differs, scaled as libavif's
    avifImageScale does (libyuv's box filter), the plane scaler against
    avifImageScale itself, and the 8 single-bit flips of
    tests/test_torch_formats_avif.py's sweeps 40 7 and 40 8 that reach it;
  - the committed fixtures in tests/data/formats_avif_matrix, each beside
    PIL's decode as PNG, and the courtyard's 12 textures as YCgCo 4:2:0
    files libavif writes at its default quality (courtyard_ycgco/),
    whose PIL decodes have the digests chip_smoke.py holds the port to.

``PYTHONPATH=. python tests/test_torch_formats_avif_matrix.py
--write-fixtures`` regenerates the fixtures and prints
COURTYARD_AVIF_YCGCO_SHA256; ``--exhaustive`` puts all 2^24 (Y, U, V)
through avifImageYUVToRGB and the port for each path, range and class of
matrix 12's primaries; with no flag it prints each fixture's decode time.
One thread, no card."""

import hashlib
import struct
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import torch_libavif as la
from plainrenderer_tpu_torch.assets import avif_reformat, avif_scale
from plainrenderer_tpu_torch.assets import avif_yuv
from plainrenderer_tpu_torch.assets import image_io as tio
from test_torch_formats import _picture, _pil, _save
from test_torch_formats_avif import (_build, _case_file, _full, _ispe,
                                     _parts, _same, _std)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
FIXTURES = Path(__file__).resolve().parent / "data" / "formats_avif_matrix"
COURTYARD = FIXTURES / "courtyard_ycgco"
# the matrices libavif 1.3.0 converts (the rest it refuses)
READ = (0, 1, 2, 4, 5, 6, 7, 8, 9, 12, 15)
SUBSAMPLING = {"420": "4:2:0", "422": "4:2:2", "400": "4:0:0",
               "444": "4:4:4"}


def _nclx(data: bytes, matrix=None, full=None, primaries=None) -> bytes:
    """data with its nclx colr property's fields rewritten in place."""
    i = data.index(b"colrnclx") + 8
    buf = bytearray(data)
    if primaries is not None:
        buf[i:i + 2] = primaries.to_bytes(2, "big")
    if matrix is not None:
        buf[i + 4:i + 6] = matrix.to_bytes(2, "big")
    if full is not None:
        buf[i + 6] = (buf[i + 6] & 0x7F) | (0x80 if full else 0)
    return bytes(buf)


@lru_cache(maxsize=None)
def _base(sub: str, full: bool, alpha: str) -> bytes:
    """PIL's save of a seeded 9 x 7 picture (odd sizes: the upsampling's
    edges), alpha "RGB", "RGBA" or "prem" (premultiplied)."""
    c = 3 if alpha == "RGB" else 4
    im = Image.fromarray(_picture(9, 7, c, 90 + c + 2 * full))
    return _save(im, "AVIF", subsampling=SUBSAMPLING[sub],
                 range="full" if full else "limited", speed=10,
                 alpha_premultiplied=alpha == "prem")


@pytest.mark.parametrize("matrix", range(256))
def test_every_matrix_at_444_full_range(tmp_path, matrix):
    """Matrix coefficients 0-255 in the nclx of a 4:4:4 full-range save:
    the JAX package's image, or both raise (3, 10, 11, 13, 14, 16-255)."""
    got = _same(tmp_path, _nclx(_base("444", True, "RGB"), matrix=matrix))
    assert (got is None) == (matrix not in READ), matrix


@pytest.mark.parametrize("alpha", ["RGB", "RGBA", "prem"])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("sub", ["420", "422", "400"])
@pytest.mark.parametrize("matrix", READ)
def test_matrix_subsampling_range_alpha(tmp_path, matrix, sub, full, alpha):
    """Each matrix libavif converts, at each subsampling, range and alpha
    form: libavif refuses YCgCo at limited range and the identity with
    subsampled chroma (it reads the identity at 4:0:0)."""
    data = _nclx(_base(sub, full, alpha), matrix=matrix, full=full)
    got = _same(tmp_path, data)
    refused = (matrix == 8 and not full) or (matrix == 0 and sub != "400")
    assert (got is None) == refused


@pytest.mark.parametrize("primaries", range(256))
def test_matrix_12_over_the_primaries(tmp_path, primaries):
    """Matrix 12 (chromaticity-derived): kr and kb from the primaries'
    table (BT.709's for values it has no entry for), or libyuv's BT.709,
    BT.601 and BT.2020 tables for primaries 1-2, 5-6 and 9."""
    data = _nclx(_base("444", True, "RGB"), matrix=12, primaries=primaries)
    assert _same(tmp_path, data) is not None


@pytest.mark.parametrize("primaries", [1, 4, 9, 22, 200])
def test_matrix_12_subsampled_limited_premultiplied(tmp_path, primaries):
    data = _nclx(_base("420", False, "prem"), matrix=12, full=False,
                 primaries=primaries)
    assert _same(tmp_path, data) is not None


LIBAVIF_FILES = {
    # name -> (encode options, channels)
    "identity_lossless_rgb": (dict(fmt="444", mc=0, lossless=True), 3),
    "identity_lossless_rgba": (dict(fmt="444", mc=0, lossless=True), 4),
    "ycgco_420": (dict(fmt="420", mc=8), 3),
    "ycgco_420_rgba": (dict(fmt="420", mc=8), 4),
    "ycgco_422": (dict(fmt="422", mc=8), 3),
    "ycgco_444_rgba": (dict(fmt="444", mc=8), 4),
    "fcc_420_limited": (dict(fmt="420", mc=4, full=False), 3),
    "smpte240_422": (dict(fmt="422", mc=7), 4),
    "derived_p22_420": (dict(fmt="420", mc=12, cp=22), 3),
    "matrix15_444": (dict(fmt="444", mc=15), 3),
}


@lru_cache(maxsize=None)
def _libavif_file(name: str, w=33, h=17) -> bytes:
    kw, c = LIBAVIF_FILES[name]
    return la.encode(_picture(w, h, c, sum(map(ord, name))), **kw)


@pytest.mark.parametrize("name", sorted(LIBAVIF_FILES))
def test_files_libavif_writes(tmp_path, name):
    """Files libavif writes in these matrices: the JAX package's image;
    the lossless identity gives back the written pixels."""
    got = _same(tmp_path, _libavif_file(name))
    assert got is not None
    if "lossless" in name:
        c = LIBAVIF_FILES[name][1]
        want = _picture(33, 17, c, sum(map(ord, name)))
        np.testing.assert_array_equal(got[..., :c], want)


# ---------------------- the arithmetic against libavif ----------------------

# (matrix, primaries) for each path: libyuv's tables, the identity, YCgCo,
# the coefficient path with a table's kr / kb, the default kr / kb (15) and
# matrix 12's derived kr / kb
PATHS = [(1, 1), (0, 1), (8, 1), (4, 1), (7, 1), (15, 1), (12, 1), (12, 4),
         (12, 10), (12, 22)]


def _triples(step: int):
    """Every Y, each with U and V on a grid of the step that Y shifts
    (every value of each plane appears; all 2^24 triples at step 1)."""
    g = np.arange(0, 256, step)
    y, u, v = np.meshgrid(np.arange(256), g, g, indexing="ij")
    u = u + y % step
    v = v + (7 * y) % step
    return [a.reshape(-1, 1024) for a in (y, u, v)]


def _check_triples(matrix, primaries, full, step) -> bool:
    """The port's RGB of the triples equals libavif's, or both refuse
    (returns whether they refused)."""
    y, u, v = _triples(step)
    r, want = la.convert([y, u, v], "444", full, matrix, primaries)
    if r != 0:
        with pytest.raises(ValueError):
            avif_yuv.yuv_to_rgba([y, u, v], 0, 0, full, matrix,
                                 primaries=primaries)
        return True
    got = avif_yuv.yuv_to_rgba([y, u, v], 0, 0, full, matrix,
                               primaries=primaries)
    np.testing.assert_array_equal(got[..., :3], want)
    return False


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("matrix,primaries", PATHS)
def test_conversion_of_sampled_triples(matrix, primaries, full):
    """2^20 (Y, U, V) triples (every Y, U and V on a 4-step grid) at
    4:4:4 through avifImageYUVToRGB and the port: equal on each."""
    _check_triples(matrix, primaries, full, 4)


@pytest.mark.parametrize("matrix,primaries", PATHS + [(9, 1), (12, 9)])
def test_conversion_of_subsampled_planes_with_alpha(matrix, primaries):
    """Random planes of odd and even sizes at each subsampling and range,
    with no alpha, straight alpha and premultiplied alpha: the port's RGBA
    equals avifImageYUVToRGB's, or both refuse."""
    rng = np.random.default_rng(matrix * 256 + primaries)
    for fmt, ssx, ssy in (("444", 0, 0), ("422", 1, 0), ("420", 1, 1),
                          ("400", 1, 1)):
        for full in (True, False):
            for w, h in ((1, 1), (2, 3), (9, 7), (16, 10)):
                y = rng.integers(0, 256, (h, w))
                cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
                u = rng.integers(0, 256, (ch, cw))
                v = rng.integers(0, 256, (ch, cw))
                planes = [y] if fmt == "400" else [y, u, v]
                for alpha in (None, "straight", "prem"):
                    a = None if alpha is None else rng.integers(0, 256,
                                                                (h, w))
                    if a is not None:
                        a.flat[0], a.flat[-1] = 0, 255
                    r, want = la.convert(planes, fmt, full, matrix,
                                         primaries, a, alpha == "prem")
                    try:
                        got = avif_yuv.yuv_to_rgba(
                            planes, ssx, ssy, full, matrix, a,
                            alpha == "prem", primaries)
                    except ValueError:
                        got = None
                    assert (r != 0) == (got is None), (fmt, full, r)
                    if got is not None:
                        np.testing.assert_array_equal(
                            got[..., :want.shape[-1]], want,
                            err_msg=f"{fmt} {full} {w}x{h} {alpha}")


def test_refusals_name_the_matrix():
    """What libavif refuses raises ValueError naming it."""
    y = np.zeros((2, 2), np.int64)
    for matrix, ss, full, word in ((3, 0, True, "matrix coefficients 3"),
                                   (16, 0, True, "matrix coefficients 16"),
                                   (8, 1, False, "YCgCo"),
                                   (0, 1, True, "identity")):
        with pytest.raises(ValueError, match=word):
            avif_yuv.yuv_to_rgba([y, y[:1, :1], y[:1, :1]] if ss else
                                 [y, y, y], ss, ss, full, matrix)
    assert avif_reformat.refusal(0, True, True, True) is None


# ------------------------- ispe and tkhd scaling ----------------------------

SCALES = [(20, 16), (30, 20), (12, 8), (18, 12), (9, 16), (48, 32),
          (1, 1), (24, 1), (7, 40), (64, 5), (9, 6), (72, 48)]


@pytest.mark.parametrize("w,h", SCALES)
def test_ispe_other_than_the_frame(tmp_path, w, h):
    """PIL's 24 x 16 save rebuilt with another ispe: libavif scales the
    decoded planes to the ispe's size (libyuv's box filter: bilinear up
    and down, the 3/4, 1/2 and 3/8 reductions, point sampling) before its
    YUV to RGB, and so does the port."""
    pl, props, _ = _parts(Image.fromarray(_picture(24, 16, 3, 70)))
    boxes, ess = _std(props, w, h)
    got = _same(tmp_path, _build([(1, b"av01", pl, boxes, ess)], 1))
    assert got is not None and got.shape == (h, w, 4)


def test_alpha_item_and_grid_tiles_other_than_their_frames(tmp_path):
    """An alpha item whose ispe is not its frame's (scaled to it, then
    held to the colour's size), and grid tiles whose ispe is not their
    frames' (each scaled before the grid is assembled)."""
    pl, props, _ = _parts(Image.fromarray(_picture(24, 16, 3, 72)))
    apl, aprops, _ = _parts(Image.fromarray(_picture(12, 8, 1, 73)[..., 0]))
    aux = _full(b"auxC", 0, 0, b"urn:mpeg:mpegB:cicp:systems:auxiliary:"
                b"alpha\0")
    boxes, ess = _std(props)
    for aw, ah in ((24, 16), (12, 8)):
        items = [(1, b"av01", pl, boxes, ess),
                 (2, b"av01", apl, [_ispe(aw, ah), aprops[b"av1C"], aux],
                  [0, 1, 0])]
        got = _same(tmp_path, _build(items, 1, refs=[(b"auxl", 2, [1])]))
        assert (got is None) == ((aw, ah) != (24, 16))
    tiles = []
    for k in range(2):
        tpl, tprops, _ = _parts(Image.fromarray(_picture(60, 70, 3, 74 + k)))
        tiles.append(tpl)
    tboxes, tess = _std(tprops, 64, 64)
    items = [(10 + k, b"av01", t, tboxes, tess) for k, t in enumerate(tiles)]
    items.append((1, b"grid", bytes([0, 0, 0, 1]) + struct.pack(">HH", 128,
                                                                 64),
                  [_ispe(128, 64), tprops[b"colr"]], [0, 0]))
    got = _same(tmp_path, _build(items, 1, refs=[(b"dimg", 1, [10, 11])]))
    assert got is not None and got.shape == (64, 128, 4)


def _tkhd_sized(data: bytes, w: int, h: int) -> bytes:
    """A sequence with its tracks' tkhd width and height rewritten."""
    buf = bytearray(data)
    at = 0
    while True:
        at = buf.find(b"tkhd", at + 1)
        if at < 0:
            return bytes(buf)
        v = buf[at + 4]
        off = at + 8 + (16 if v == 1 else 8) + 4 + (12 if v == 1 else 8) + 52
        buf[off:off + 8] = struct.pack(">II", w << 16, h << 16)


@pytest.mark.parametrize("w,h", [(26, 18), (20, 15), (40, 30), (0, 18)])
def test_sequence_tkhd_other_than_the_frame(tmp_path, w, h):
    """A 3-frame RGBA sequence whose tracks' tkhd size is rewritten:
    libavif scales frame 0 and its alpha to it, and refuses a zero size."""
    frames = [Image.fromarray(_picture(26, 18, 4, 60 + k)) for k in range(3)]
    data = _save(frames[0], "AVIF", save_all=True, append_images=frames[1:])
    got = _same(tmp_path, _tkhd_sized(data, w, h))
    assert (got is None) == (w == 0)


# the single-bit flips of test_torch_formats_avif.py's --sweep 40 7 and
# 40 8 that change an ispe or an AV1 frame size: (case, bit)
SWEEP_FLIPS = [("s422", 1510), ("lossless", 1535), ("q0", 1531),
               ("cdef_lr", 1563), ("rgba_prem", 6718), ("grain444", 1539),
               ("q0", 2255), ("q0", 1572)]


@pytest.mark.parametrize("case,bit", SWEEP_FLIPS)
def test_sweep_flips_that_resize(tmp_path, case, bit):
    buf = bytearray(_case_file(case))
    buf[bit >> 3] ^= 0x80 >> (bit & 7)
    _same(tmp_path, bytes(buf))


@pytest.mark.parametrize("sw,sh", [(1, 1), (3, 5), (16, 12), (24, 16),
                                   (32, 32), (33, 17), (64, 48), (5, 64)])
def test_scale_plane_matches_avif_image_scale(sw, sh):
    """assets/avif_scale.scale_plane against libavif's avifImageScale on a
    random plane, to every size on a grid and to the sizes of each
    special path (3/4, 1/2, 3/8, 1/4, 2x, a third)."""
    rng = np.random.default_rng(sw * 100 + sh)
    src = rng.integers(0, 256, (sh, sw))
    sizes = {1, 2, 3, 5, 8, 13, 24, 40}
    dims = sorted({(dw, dh) for dw in sizes for dh in sizes} | {
        (max(1, sw * a // b), max(1, sh * a // b))
        for a, b in ((3, 4), (1, 2), (3, 8), (1, 4), (2, 1), (1, 3))} | {
        (sw, 2 * sh), (2 * sw, sh), (sw, max(1, sh // 3))})
    for dw, dh in dims:
        np.testing.assert_array_equal(avif_scale.scale_plane(src, dw, dh),
                                      la.scale(src, dw, dh),
                                      err_msg=f"{sw}x{sh} -> {dw}x{dh}")


# ------------------------------ fixtures ------------------------------

def courtyard_files() -> dict:
    """The courtyard's 12 textures as YCgCo 4:2:0 AVIF files libavif
    writes at its default quality (RGBA maps with their alpha)."""
    out = {}
    for png in sorted(DEMO.glob("*.png")):
        im = Image.open(png)
        im = im.convert("RGBA" if "A" in im.getbands() else "RGB")
        out[png.stem + ".avif"] = la.encode(np.asarray(im), fmt="420", mc=8)
    return out


def fixture_files() -> dict:
    """Small files for each conversion path chip_smoke.py checks on the
    card's machine, and one lossless identity texture (a 64 x 64 corner of
    the ivy albedo with its alpha)."""
    ivy = np.asarray(Image.open(DEMO / "ivy_albedo.png").convert("RGBA"))
    pl, props, _ = _parts(Image.fromarray(_picture(24, 16, 3, 70)))
    boxes, ess = _std(props, 20, 16)
    boxes2, ess2 = _std(props, 30, 20)
    return {
        "identity_lossless_texture.avif": la.encode(
            np.ascontiguousarray(ivy[:64, :64]), fmt="444", mc=0,
            lossless=True),
        "ycgco_420_rgba.avif": _libavif_file("ycgco_420_rgba"),
        "ycgco_422.avif": _libavif_file("ycgco_422"),
        "fcc_420_limited.avif": _libavif_file("fcc_420_limited"),
        "smpte240_422_rgba.avif": _libavif_file("smpte240_422"),
        "derived_p22_420.avif": _libavif_file("derived_p22_420"),
        "matrix15_444.avif": _libavif_file("matrix15_444"),
        "identity_400.avif": _nclx(_base("400", True, "RGBA"), matrix=0),
        "derived_p9_420_prem.avif": _nclx(_base("420", False, "prem"),
                                          matrix=12, primaries=9),
        "ispe_20x16.avif": _build([(1, b"av01", pl, boxes, ess)], 1),
        "ispe_30x20.avif": _build([(1, b"av01", pl, boxes2, ess2)], 1),
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
    print("COURTYARD_AVIF_YCGCO_SHA256 = " + repr(courtyard_digests()))


def courtyard_digests() -> dict:
    """SHA-256 of PIL's RGBA decode of each committed YCgCo courtyard
    file."""
    return {p.stem: hashlib.sha256(np.ascontiguousarray(np.asarray(
        Image.open(p).convert("RGBA"))).tobytes()).hexdigest()
        for p in sorted(COURTYARD.glob("*.avif"))}


def test_committed_fixtures_equal_pil_and_their_pngs():
    """Each committed file decodes in the port as in PIL and equals the
    PNG of PIL's decode beside it; the set is the one fixture_files
    makes."""
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if p.is_file() and not p.name.endswith(".png"))
    assert names == sorted(fixture_files())
    for name in names:
        data = (FIXTURES / name).read_bytes()
        got = tio.load_image(FIXTURES / name)
        np.testing.assert_array_equal(got, tio.load_image(
            FIXTURES / (name + ".png")), err_msg=name)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)


def test_courtyard_ycgco_digests_are_pils():
    """The 12 committed YCgCo courtyard files: PIL's decodes have the
    digests chip_smoke.COURTYARD_AVIF_YCGCO_SHA256 holds the port to on the
    card's machine; the port decodes the metal maps to those digests here
    (the rest on the card's machine, for time); together the files stay
    under 150 KB, and the folder with them under 300 KB."""
    import chip_smoke

    assert courtyard_digests() == chip_smoke.COURTYARD_AVIF_YCGCO_SHA256
    assert sorted(p.name for p in COURTYARD.iterdir()) == sorted(
        p.stem + ".avif" for p in DEMO.glob("*.png"))
    for p in sorted(COURTYARD.glob("metal_*.avif")):
        digest = hashlib.sha256(tio.load_image(p).tobytes()).hexdigest()
        assert digest == chip_smoke.COURTYARD_AVIF_YCGCO_SHA256[p.stem]
    assert sum(p.stat().st_size for p in COURTYARD.iterdir()) < 150_000
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 300_000


def exhaustive():
    """All 2^24 (Y, U, V) at 4:4:4 through avifImageYUVToRGB and the port,
    for each path and range and each class of matrix 12's primaries."""
    cases = [(m, p) for m, p in PATHS] + [(12, p) for p in (
        0, 2, 3, 5, 6, 7, 8, 9, 11, 12, 13)] + [(2, 1), (5, 1), (6, 1),
                                                (9, 1)]
    for matrix, primaries in cases:
        for full in (True, False):
            refused = _check_triples(matrix, primaries, full, 1)
            print(f"matrix {matrix} primaries {primaries} "
                  f"{'full' if full else 'limited'}: "
                  f"{'refused by both' if refused else 'all 2^24 equal'}",
                  flush=True)


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
    elif "--exhaustive" in sys.argv:
        exhaustive()
    else:
        print_decode_times()
