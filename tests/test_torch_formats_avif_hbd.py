"""10 and 12-bit AVIF in the port (the AV1 decoder's high bit depth paths in
assets/av1_*.py, and avif_yuv.py, avif_reformat.py and avif_scale.py on
10 and 12-bit planes) against PIL 12.1's AVIF plugin (libavif 1.3.0 with
dav1d 1.5.1), which the JAX package's load_image uses:

  - every committed AVIF fixture of tests/data/formats_avif and
    tests/data/formats_avif_matrix rewritten to 10 and to 12 bits by
    tests/torch_avif_depth.py: load_image equals the JAX package's bit
    for bit, or both raise (the courtyard textures rewritten:
    tests/test_torch_formats_avif_hbd_courtyard.py);
  - the committed rewritten files in tests/data/formats_avif_hbd: the
    rewrite of their sources, and PIL's decodes have the digests
    chip_smoke.AVIF_HBD_SHA256 holds the port to on the card's machine;
  - a seeded sweep of single bit flips over rewritten files, and each box
    type altered in three of them: the same image as PIL's, or both
    raise; and the flip whose out-of-range coefficients dav1d's assembly
    clips otherwise than its C functions: equal to PIL's C path;
  - avif_yuv.yuv_to_rgba (libyuv's and libavif's own paths) on seeded 10
    and 12-bit planes in every matrix, range and subsampling, with
    straight and premultiplied alpha, and avif_scale.scale_plane on 10
    and 12-bit planes: equal to avifImageYUVToRGB and avifImageScale
    through tests/torch_libavif.py;
  - the 10 and 12-bit Dc_Qlookup / Ac_Qlookup rows equal to dav1d's
    dq_tbl in PIL's libavif .so, found there by its 8-bit rows.

``PYTHONPATH=. python tests/test_torch_formats_avif_hbd.py
--write-fixtures`` regenerates tests/data/formats_avif_hbd and prints
chip_smoke's AVIF_HBD_SHA256; ``--sweep N SEED`` runs N seeded flips in
each rewritten fixture against PIL and prints what differs, and with
``--both-masks`` also what differs from PIL with dav1d kept to its C
functions (dav1d_set_cpu_flags_mask(0)). One thread, no card."""

import glob
import hashlib
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import torch_avif_depth
import torch_libavif as la
from plainrenderer_tpu_torch.assets import (av1_obu, av1_transform,
                                            avif_scale, avif_yuv, isobmff)
from plainrenderer_tpu_torch.assets import image_io as tio
from test_torch_formats_avif import _same

torch.set_num_threads(1)
DATA = Path(__file__).resolve().parent / "data"
SOURCES = sorted([*(DATA / "formats_avif").glob("*.avif"),
                  *(DATA / "formats_avif_matrix").glob("*.avif")])
FIXTURES = DATA / "formats_avif_hbd"
# the courtyard texture rewritten to 10 bits for chip_smoke.py
COURTYARD_SOURCE = DATA / "formats_avif" / "courtyard" / "wood_albedo.avif"


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("src", SOURCES, ids=lambda p: p.name)
def test_fixture_at_depth_equals_pil(tmp_path, src, depth):
    data = torch_avif_depth.to_depth(src.read_bytes(), depth)
    f = isobmff.parse(data)
    pl = isobmff.item_payload(data, f, f.items[f.primary]) \
        if f.primary in f.items and f.items[f.primary].type == b"av01" \
        else None
    if pl is not None:
        s, e = next((s, e) for t, _, _, s, e in av1_obu.obus(pl)
                    if t == av1_obu.OBU_SEQUENCE_HEADER)
        assert av1_obu.sequence_header(pl, s, e).bit_depth == depth
    _same(tmp_path, data)


def fixture_files() -> dict:
    """The committed rewritten files: every source at 10 and 12 bits, and
    one courtyard texture at 10."""
    out = {}
    for src in SOURCES:
        for depth in (10, 12):
            out[f"{src.stem}_{depth}.avif"] = torch_avif_depth.to_depth(
                src.read_bytes(), depth)
    out[f"courtyard_{COURTYARD_SOURCE.stem}_10.avif"] = \
        torch_avif_depth.to_depth(COURTYARD_SOURCE.read_bytes(), 10)
    return out


def pil_digests() -> dict:
    """SHA-256 of PIL's RGBA decode of each committed file, None where PIL
    refuses it."""
    out = {}
    for p in sorted(FIXTURES.glob("*.avif")):
        try:
            with Image.open(p) as im:
                a = np.ascontiguousarray(np.asarray(im.convert("RGBA")))
            out[p.stem] = hashlib.sha256(a.tobytes()).hexdigest()
        except Exception:  # noqa: BLE001 - PIL's refusal
            out[p.stem] = None
    return out


def test_committed_fixtures_are_the_rewrites_and_pils_digests():
    """tests/data/formats_avif_hbd holds the rewrite of each source (and
    nothing else), PIL decodes them to chip_smoke.AVIF_HBD_SHA256 (None:
    PIL refuses the file), and the folder stays under 200 KB."""
    import chip_smoke

    files = fixture_files()
    assert sorted(p.name for p in FIXTURES.iterdir()) == sorted(files)
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
    assert pil_digests() == chip_smoke.AVIF_HBD_SHA256
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 200_000


SWEEP = ["default_rgb", "rgba_premultiplied", "limited_422",
         "lossless_444", "grain", "mono_400", "idat", "sequence_rgba"]


@pytest.mark.parametrize("seed", range(4))
def test_bit_flips_match_jax(tmp_path, seed):
    """Single bit flips, seeded, in rewritten files: PIL's image or both
    raise."""
    rng = np.random.default_rng(seed)
    for k, name in enumerate(SWEEP):
        data = (FIXTURES / f"{name}_{10 + 2 * ((seed + k) % 2)}.avif"
                ).read_bytes()
        buf = bytearray(data)
        bit = int(rng.integers(0, len(data) * 8))
        buf[bit >> 3] ^= 0x80 >> (bit & 7)
        _same(tmp_path, bytes(buf), f"flip{k}.avif")


def _box_heads(data: bytes) -> list:
    """The offset of every box's type in the file, containers walked."""
    heads = []
    inner = {b"meta": 4, b"stsd": 8, b"av01": 78}

    def walk(s, e, top=False):
        for typ, bs, be in isobmff.boxes(data, s, e, top=top):
            heads.append(bs - 4)
            if typ in (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf",
                       b"edts", b"iprp", b"ipco", b"tref") or (
                    typ in inner and be - bs > inner[typ]):
                walk(bs + inner.get(typ, 0), be)

    walk(0, len(data), True)
    return heads


@pytest.mark.parametrize("name", ["sequence_rgba_10", "rgba_premultiplied_12",
                                  "grid_10"])
def test_altered_box_types_match_jax(tmp_path, name):
    """Each box's type with its last letter's case flipped (the box
    unknown to libavif): PIL's image or both raise, libavif's parse rules
    for items, properties and tracks held."""
    data = (FIXTURES / f"{name}.avif").read_bytes()
    for k, at in enumerate(_box_heads(data)):
        buf = bytearray(data)
        buf[at + 3] ^= 0x20
        _same(tmp_path, bytes(buf), f"box{k}.avif")


def test_flipped_coefficients_follow_dav1ds_c_path():
    """matrix15_444_10.avif with bit 2308 flipped codes a 16 x 8 CfL
    block's DCT_DCT coefficients of +-131072, out of every conformant
    stream's range: dav1d's x86 assembly clips them otherwise than its C
    itx_1d.c, so PIL's decode depends on the host's CPU (33 of the 17 x 33
    pixels differ between the two paths). The port follows the C path:
    equal to PIL's decode under dav1d_set_cpu_flags_mask(0) on every
    pixel; the default mask is restored for the decodes that follow."""
    buf = bytearray((FIXTURES / "matrix15_444_10.avif").read_bytes())
    buf[2308 >> 3] ^= 0x80 >> (2308 & 7)
    data = bytes(buf)
    la.dav1d_cpu_mask(0)
    try:
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGBA"))
    finally:
        la.dav1d_cpu_mask(0xFFFFFFFF)
    got = tio.decode_image(data, "flip.avif", ".avif")
    assert want.shape == (17, 33, 4)
    np.testing.assert_array_equal(got, want)


# ------------------------ conversion and scaling ------------------------

MATRICES = [(1, 1), (2, 1), (6, 1), (9, 1), (0, 1), (8, 1), (4, 1), (7, 1),
            (15, 1), (12, 1), (12, 4), (12, 9), (12, 22)]


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("matrix,primaries", MATRICES)
def test_conversion_matches_libavif(depth, matrix, primaries):
    """Seeded 10 / 12-bit planes of odd and even sizes at each
    subsampling and range, with no alpha, straight and premultiplied
    alpha: the port's RGBA equals avifImageYUVToRGB's, or both refuse."""
    rng = np.random.default_rng(depth * 1000 + matrix * 32 + primaries)
    top = 1 << depth
    for fmt, ssx, ssy in (("444", 0, 0), ("422", 1, 0), ("420", 1, 1),
                          ("400", 1, 1)):
        for full in (True, False):
            for w, h in ((1, 1), (2, 3), (17, 9), (16, 10)):
                cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
                y = rng.integers(0, top, (h, w))
                planes = [y] if fmt == "400" else [
                    y, rng.integers(0, top, (ch, cw)),
                    rng.integers(0, top, (ch, cw))]
                for alpha in (None, "straight", "prem"):
                    a = None if alpha is None else rng.integers(0, top,
                                                                (h, w))
                    if a is not None:
                        a.flat[0], a.flat[-1] = 0, top - 1
                    r, want = la.convert(planes, fmt, full, matrix,
                                         primaries, a, alpha == "prem",
                                         depth)
                    try:
                        got = avif_yuv.yuv_to_rgba(
                            [p.astype(np.uint16) for p in planes], ssx, ssy,
                            full, matrix, a, alpha == "prem", primaries,
                            depth)
                    except ValueError:
                        got = None
                    assert (r != 0) == (got is None), (fmt, full, r)
                    if got is not None:
                        np.testing.assert_array_equal(
                            got[..., :want.shape[-1]], want,
                            err_msg=f"{fmt} {full} {w}x{h} {alpha}")


def test_limited_alpha_is_avif_limited_to_full():
    """avifLimitedToFullY at 10 and 12 bits, as at 8: the limited range
    stretched to the full one with C's truncating division."""
    for depth, lo, hi in ((8, 16, 235), (10, 64, 940), (12, 256, 3760)):
        top = (1 << depth) - 1
        v = np.arange(top + 1)
        got = avif_yuv.limited_to_full_alpha(v, depth)
        n = (v - lo) * top
        want = np.clip(np.sign(n) * (np.abs(n) // (hi - lo)), 0, top)
        np.testing.assert_array_equal(got, want)
        assert got[lo] == 0 and got[hi] == top


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("sw,sh", [(1, 1), (3, 5), (16, 12), (24, 16),
                                   (33, 17), (64, 48), (5, 64)])
def test_scale_plane_matches_avif_image_scale(depth, sw, sh):
    """avif_scale.scale_plane on a seeded 10 / 12-bit plane against
    avifImageScale, to every size on a grid and to each special path's
    size (3/4, 1/2, 3/8, 1/4, 2x, a third)."""
    rng = np.random.default_rng(depth * 10000 + sw * 100 + sh)
    src = rng.integers(0, 1 << depth, (sh, sw))
    sizes = {1, 2, 3, 5, 8, 13, 24, 40}
    dims = sorted({(dw, dh) for dw in sizes for dh in sizes} | {
        (max(1, sw * a // b), max(1, sh * a // b))
        for a, b in ((3, 4), (1, 2), (3, 8), (1, 4), (2, 1), (1, 3))} | {
        (sw, 2 * sh), (2 * sw, sh), (sw, max(1, sh // 3))})
    for dw, dh in dims:
        np.testing.assert_array_equal(
            avif_scale.scale_plane(src, dw, dh, depth),
            la.scale(src, dw, dh, depth), err_msg=f"{sw}x{sh} -> {dw}x{dh}")


def test_dequantisation_tables_are_dav1ds():
    """dav1d's dq_tbl[3][256][2] (dc, ac) in the wheel's libavif .so,
    found by its 8-bit rows, holds the port's 10 and 12-bit rows."""
    so = glob.glob(os.path.join(la.LIBS, "libavif-*.so*"))[0]
    raw = Path(so).read_bytes()
    t = np.stack([av1_transform.DC_Q, av1_transform.AC_Q], -1)   # (3, 256, 2)
    at = raw.find(t[0].astype("<u2").tobytes())
    assert at >= 0
    found = np.frombuffer(raw, "<u2", 3 * 256 * 2, at).reshape(3, 256, 2)
    np.testing.assert_array_equal(found, t)
    assert tuple(t[1, -1]) == (5347, 7312) and tuple(t[2, -1]) == (21387,
                                                                   29247)


# ------------------------------- command line ------------------------------

def write_fixtures():
    FIXTURES.mkdir(exist_ok=True)
    for p in FIXTURES.iterdir():
        p.unlink()
    for name, data in fixture_files().items():
        (FIXTURES / name).write_bytes(data)
    print("AVIF_HBD_SHA256 = {")
    for k, v in pil_digests().items():
        print(f'    "{k}": ' + (f'"{v[:32]}"\n        "{v[32:]}",' if v
                                else "None,"))
    print("}")


def _pil_or_error(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA"))
    except Exception as e:  # noqa: BLE001
        return e


def _differ(want, got) -> bool:
    return isinstance(want, Exception) != isinstance(got, Exception) or (
        not isinstance(want, Exception) and not np.array_equal(want, got))


def sweep_flips(n: int, seed: int, both_masks: bool = False) -> dict:
    """n seeded flips in each fixture: the port against PIL ("differ");
    with both_masks also against PIL with dav1d kept to its C functions
    (dav1d_set_cpu_flags_mask(0): "differ_c")."""
    rng = np.random.default_rng(seed)
    out = {"differ": [], "cases": 0}
    if both_masks:
        out["differ_c"] = []
    for p in sorted(FIXTURES.glob("*.avif")):
        data = p.read_bytes()
        for _ in range(n):
            buf = bytearray(data)
            bit = int(rng.integers(0, len(data) * 8))
            buf[bit >> 3] ^= 0x80 >> (bit & 7)
            want = _pil_or_error(bytes(buf))
            try:
                got = tio.decode_image(bytes(buf), p.name, ".avif")
            except ValueError as e:
                got = e
            out["cases"] += 1
            if _differ(want, got):
                out["differ"].append((p.name, bit))
            if both_masks:
                la.dav1d_cpu_mask(0)
                try:
                    want = _pil_or_error(bytes(buf))
                finally:
                    la.dav1d_cpu_mask(0xFFFFFFFF)
                if _differ(want, got):
                    out["differ_c"].append((p.name, bit))
    return out


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
    elif "--sweep" in sys.argv:
        i = sys.argv.index("--sweep")
        print(sweep_flips(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                          "--both-masks" in sys.argv))
